"""FakeNews's towers in the port (``models/zoo.py``'s ``TextTransformer``
and ``FakeNewsEmbedFusionNet``, ``models/resnet.py``'s Bottleneck
encoder) against the JAX package's flax modules on the CPU.

Tolerances: ``TextTransformer`` and the Bottleneck encoder in fp32 within
1e-5 of the largest entry (eval mode; 1e-4 in train mode, where BN over a
small batch amplifies the convs' last-bit differences, as in
``test_torch_port_enrico_towers.py``); ``TextTransformer`` in bf16 within
2^-6 of the largest entry (bf16 keeps 8 bits; the two frameworks round
the softmax, the GELU and the pool's sum at different points).  The
embed net's image tower is held in float64: its fp32 gradient parts from
JAX's by about 1% of the largest entry at the first step (its many
BN-normalised ReLU inputs put some within rounding of zero at every seed
tried), where in float64 the two agree to 1e-13; three Adam steps of the
whole net (the real Bottleneck width, one block a stage) end within 1e-8
of each tensor's largest entry in float64 on both sides.  The key map is
the bit-equal inverse of ``port_bottleneck_encoder``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_clinical_tpu.engine import state as jax_state
from multimodal_clinical_tpu.models import resnet as jax_resnet
from multimodal_clinical_tpu.models import torch_port
from multimodal_clinical_tpu.models import zoo as jax_zoo
from multimodal_clinical_tpu_torch.benchmarks import fakenews
from multimodal_clinical_tpu_torch.engine.state import make_optimizer
from multimodal_clinical_tpu_torch.models import common, zoo
from multimodal_clinical_tpu_torch.models.jax_weights import (
    load_jax_variables,
)
from multimodal_clinical_tpu_torch.models.resnet import (
    BottleneckResNetEncoder, resnet152_encoder,
)
from torch_port_benchmark_harness import patch_dropout

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False

FWD_TOL, TRAIN_FWD_TOL = 1e-5, 1e-4
BF16_TOL = 2.0 ** -6


def _scaled_err(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() / np.abs(
        want).max()


def _ids(rng, b=4, length=16, vocab=300):
    ids = rng.integers(1, vocab, (b, length)).astype(np.int32)
    ids[0, 10:] = 0
    ids[1] = 0  # padding only: uniform attention, pooled over no token
    ids[2, 1:] = 0
    return ids


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_transformer_matches_flax(dtype):
    """The real tower (256 wide, 4 heads, 2 layers) over rows with a
    padded tail, one all padding and one of a single token; the flax
    tree through ``jax_key_map``."""
    ids = _ids(np.random.default_rng(0))
    jdt = None if dtype == "float32" else jnp.bfloat16
    jtower = jax_zoo.TextTransformer(vocab_size=300, dtype=jdt)
    variables = jax.jit(lambda r, x: jtower.init(r, x))(
        jax.random.PRNGKey(1), jnp.asarray(ids))
    want = np.asarray(jax.jit(jtower.apply)(variables, jnp.asarray(ids)),
                      np.float32)
    tower = zoo.TextTransformer(vocab_size=300,
                                dtype=getattr(torch, dtype)
                                if dtype != "float32" else None)
    load_jax_variables(tower, jax.tree_util.tree_map(
        np.asarray, variables["params"]), {})
    with torch.no_grad():
        got = tower(torch.from_numpy(ids))
    assert got.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    assert torch.isfinite(got).all()
    got = got.float().numpy()
    assert _scaled_err(got, want) <= (FWD_TOL if dtype == "float32"
                                      else BF16_TOL), dtype
    # the all-padding row pools over no token: zeros on both sides
    assert not got[1].any() and not want[1].any()


def test_attention_of_an_all_padding_row_is_uniform():
    """flax masks with the dtype's lowest finite value, so a row with no
    real token attends uniformly where -inf masking would give NaN."""
    attn = zoo.SelfAttention(8, 2)
    x = torch.randn(2, 5, 8)
    mask = torch.tensor([[True] * 3 + [False] * 2, [False] * 5])
    out = attn(x, mask)
    assert torch.isfinite(out).all()
    v = attn.value(x[1]).unflatten(-1, (2, -1)).mean(0).flatten()
    torch.testing.assert_close(out[1], attn.out(v).expand(5, -1))


@pytest.mark.parametrize("train", [True, False])
def test_bottleneck_encoder_matches_flax(train):
    """Two Bottleneck blocks a stage (the projection on each stage's
    first), fp32, and the BN statistics it updates in train mode."""
    x = np.random.default_rng(2).random((3, 64, 64, 3)).astype(np.float32)
    jenc = jax_resnet.BottleneckResNetEncoder(stage_sizes=(2, 1, 2, 1))
    variables = jax.jit(lambda r, x: jenc.init(r, x, train=False))(
        jax.random.PRNGKey(3), jnp.asarray(x))
    want, new = jax.jit(lambda v, x: jenc.apply(
        v, x, train=train, mutable=["batch_stats"]))(variables,
                                                      jnp.asarray(x))
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    enc = load_jax_variables(BottleneckResNetEncoder(3, (2, 1, 2, 1)),
                             to_np(variables["params"]),
                             to_np(variables["batch_stats"]))
    assert enc.layer1[0].downsample is not None  # stage 0 too
    assert enc.layer1[1].downsample is None
    assert (enc.layer3[0].bn3.weight == 1).all()
    enc.train(train)
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    assert got.shape == want.shape == (3, 2, 2, 2048)
    tol = TRAIN_FWD_TOL if train else FWD_TOL
    assert _scaled_err(got.numpy(), want) <= tol
    if not train:
        return
    stats = load_jax_variables(BottleneckResNetEncoder(3, (2, 1, 2, 1)),
                               to_np(variables["params"]),
                               to_np(new["batch_stats"])).state_dict()
    for key, value in enc.state_dict().items():
        if "running" in key:
            assert _scaled_err(value.numpy(), stats[key].numpy()) <= tol, key


def test_bottleneck_key_map_inverts_torch_port():
    """``jax_key_map`` is the exact inverse of ``port_bottleneck_encoder``
    on a torchvision-layout state_dict."""
    torch.manual_seed(0)
    enc = BottleneckResNetEncoder(3, (1, 2, 1, 1), width=16)
    for value in enc.state_dict().values():
        value.normal_()
    params, stats = torch_port.port_bottleneck_encoder(
        enc.state_dict(), stage_sizes=(1, 2, 1, 1))
    back = load_jax_variables(BottleneckResNetEncoder(3, (1, 2, 1, 1),
                                                      width=16),
                              params, stats)
    for key, value in enc.state_dict().items():
        assert torch.equal(back.state_dict()[key], value), key


def test_resnet152_geometry():
    """The embed net's image tower is ``resnet152_encoder``'s: torchvision
    resnet152 without its fc."""
    enc = fakenews.FakeNewsEmbedFusionNet(6).image_module
    ref = resnet152_encoder()
    assert enc.stage_sizes == ref.stage_sizes == (3, 8, 36, 3)
    assert enc.out_features == ref.out_features == 2048
    assert {k: v.shape for k, v in enc.state_dict().items()} == {
        k: v.shape for k, v in ref.state_dict().items()}
    assert sum(p.numel() for p in enc.parameters()) == 58_143_808


F64_TOL = 1e-8


@pytest.mark.parametrize("with_dialogue", [False, True])
def test_embed_net_adam_steps_match_jax_in_float64(with_dialogue):
    """Three Adam steps (the spec's 1e-4) on the CE of the fused head in
    train mode, float64 on both sides, the fusion dropout's masks
    injected: every parameter and BN statistic within F64_TOL of each
    tensor's largest entry."""
    stages = (1, 1, 1, 1)
    jnet = jax_zoo.FakeNewsEmbedFusionNet(
        6, with_dialogue=with_dialogue, image_stage_sizes=stages)
    make = lambda: zoo.FakeNewsEmbedFusionNet(
        6, with_dialogue=with_dialogue, image_stage_sizes=stages)
    rng = np.random.default_rng(4)
    inputs = [rng.normal(size=(4, 768)), rng.random((4, 32, 32, 3)),
              rng.normal(size=(4, 768))][:3 if with_dialogue else 2]
    labels = np.array([0, 5, 2, 1])
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    with pytest.MonkeyPatch.context() as mp:
        source, drawn = patch_dropout(mp, 1)
        variables = jax.jit(lambda r, *xs: jnet.init(r, *xs, train=False))(
            jax.random.PRNGKey(2),
            *[jnp.asarray(x, jnp.float32) for x in inputs])
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), variables)
        net = load_jax_variables(make(), variables["params"],
                                 variables["batch_stats"], np.float64)
        net.double().train()
        opt = make_optimizer(net.parameters(), 1e-4, optimizer="adam")
        for _ in range(3):
            opt.zero_grad()
            with common.dropout_source(source(None)):
                logits = net(*map(torch.from_numpy, inputs))["logits"][0]
            torch.nn.functional.cross_entropy(
                logits, torch.from_numpy(labels)).backward()
            opt.step()
        tx = jax_state.make_optimizer(optax.constant_schedule(1e-4),
                                      optimizer="adam")
        with jax.enable_x64(True):
            params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
            stats = jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"])
            opt_state = tx.init(params)

            def loss(p, stats):
                out, new = jnet.apply(
                    {"params": p, "batch_stats": stats},
                    *map(jnp.asarray, inputs), train=True,
                    mutable=["batch_stats"],
                    rngs={"dropout": jax.random.PRNGKey(0)})
                return optax.softmax_cross_entropy_with_integer_labels(
                    out["logits"][0], jnp.asarray(labels)).mean(), new

            grad = jax.jit(jax.grad(loss, has_aux=True))
            for _ in range(3):
                grads, new = grad(params, stats)
                stats = new["batch_stats"]
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
    assert len(drawn["port"]) == 3 and drawn["jax"] == drawn["port"][:1]
    want = load_jax_variables(make().double(), to_np(params), to_np(stats),
                              np.float64).state_dict()
    for key, value in net.state_dict().items():
        got, ref = value.numpy(), want[key].numpy()
        assert np.abs(got - ref).max() <= F64_TOL * np.abs(ref).max(), key
