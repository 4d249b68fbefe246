"""The port's BERT (``models/bert.py``) and the attention-weight dropout of
``models/zoo.py`` against the JAX package's flax modules on the CPU.

Geometry: ``tests/test_food101_legacy.py``'s narrowed BERT (2 layers,
width 32, 4 heads, MLP 128, a 200-id vocabulary, 16 tokens), the flax
tree carried across by ``models/jax_weights.py``; rows padded at their
tails, one of padding only.

Tolerances are the SigLIP towers' (``test_torch_port_siglip.py``): fp32
forwards and every parameter gradient within 1e-5 of each tensor's
largest entry (the same products summed in another order); the key
projections' biases, whose gradient is zero in exact arithmetic (the
softmax over the keys is shift invariant), below 1e-6 on both sides;
bf16 forwards within 2^-6 of the largest entry (bf16 keeps 8 bits, and
the two frameworks round the softmax, the GELU and the sums at different
points).  Dropout masks are injected on both sides
(``torch_port_benchmark_harness.patch_dropout``: flax's ``nn.Dropout``
and attention-weight draws, the port's ``dropout_source``).  Weight
loading is bit-exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from multimodal_clinical_tpu.models import bert as jbert
from multimodal_clinical_tpu.models.torch_port import port_bert
from multimodal_clinical_tpu_torch.models import bert as pbert
from multimodal_clinical_tpu_torch.models import common, zoo
from multimodal_clinical_tpu_torch.models.jax_weights import (
    get_leaf, jax_key_map, load_jax_variables, to_torch_layout,
)
from torch_port_benchmark_harness import patch_dropout

torch.set_num_threads(2)

FWD_TOL = GRAD_TOL = 1e-5
BF16_TOL = 2.0 ** -6
ROUNDING_GRAD = 1e-6
B, L = 3, 16
TINY = dict(vocab_size=200, width=32, num_layers=2, heads=4, mlp_dim=128)
# the seven draws of a train forward, in flax's order
DRAWS = [((B, L, 32), 0.9)] + [((1, 1, L, L), 0.9), ((B, L, 32), 0.9),
                               ((B, L, 32), 0.9)] * 2
to_np = functools.partial(jax.tree_util.tree_map, np.asarray)


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _ids(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, TINY["vocab_size"], (B, L)).astype(np.int32)
    ids[0, 11:] = 0
    ids[1] = 0  # a row of padding only
    return ids


@functools.lru_cache(maxsize=None)
def _flax_params():
    """The narrowed flax BertEncoder's parameters (numpy), one jitted
    init."""
    variables = jax.jit(functools.partial(
        jbert.BertEncoder(**TINY).init, train=False))(
            jax.random.PRNGKey(2), jnp.asarray(_ids()))
    return to_np(variables["params"])


def _pair(dtype):
    """(flax BertEncoder, the port's with the flax weights) in ``dtype``."""
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    model = pbert.BertEncoder(**TINY, dtype=tdt)
    load_jax_variables(model, _flax_params(), {})
    return jbert.BertEncoder(**TINY, dtype=jdt), model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_flax(train, dtype):
    """The last hidden states (fp32 after the post-LNs) in eval mode, and
    in train mode with the seven injected dropout masks."""
    jmodel, model = _pair(dtype)
    ids = _ids()
    model.train(train)
    with pytest.MonkeyPatch.context() as mp:
        source, drawn = patch_dropout(mp, len(DRAWS), nchw=False)
        want = jmodel.apply({"params": _flax_params()}, jnp.asarray(ids),
                            train=train,
                            rngs={"dropout": jax.random.PRNGKey(3)})
        with torch.no_grad(), common.dropout_source(source(None)):
            got = model(torch.from_numpy(ids))
    assert drawn["jax"] == (DRAWS if train else [])
    assert drawn["port"] == drawn["jax"]
    assert got.dtype == torch.float32 and str(np.asarray(want).dtype) == (
        "float32")
    assert got.shape == (B, L, TINY["width"])
    tol = FWD_TOL if dtype == "float32" else BF16_TOL
    assert _scaled_err(got.numpy(), want) <= tol


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_gradients_match_flax(train):
    """fp32: every parameter's gradient of a fixed projection of the last
    [CLS] hidden states (what ``BertClassifier`` reads), in train mode
    through the injected masks."""
    jmodel, model = _pair("float32")
    ids = _ids(1)
    proj = np.random.default_rng(5).normal(
        size=(B, TINY["width"])).astype(np.float32)
    model.train(train)
    with pytest.MonkeyPatch.context() as mp:
        source, _ = patch_dropout(mp, len(DRAWS), nchw=False)
        grads = jax.grad(lambda p: (jmodel.apply(
            {"params": p}, jnp.asarray(ids), train=train,
            rngs={"dropout": jax.random.PRNGKey(3)})[:, 0] * proj).sum())(
                _flax_params())
        with common.dropout_source(source(None)):
            (model(torch.from_numpy(ids))[:, 0] * torch.from_numpy(proj)
             ).sum().backward()
    named = dict(model.named_parameters())
    for key, (_, path, kind) in jax_key_map(model).items():
        got = named[key].grad.numpy()
        want = to_torch_layout(kind, get_leaf(grads, path))
        if key.endswith("attention.self.key.bias"):
            assert np.abs(got).max() <= ROUNDING_GRAD, key
            assert np.abs(want).max() <= ROUNDING_GRAD, key
        else:
            assert _scaled_err(got, want) <= GRAD_TOL, key
    assert set(jax_key_map(model)) == set(named)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_dropout_matches_flax(dtype):
    """``zoo.dot_product_attention`` at rate 0.1 against flax's
    ``dot_product_attention`` with ``broadcast_dropout``: one (1, 1, Lq,
    Lk) keep mask for the batch and every head, applied as ``weights *
    (keep / keep_prob)`` in the compute dtype, after the masked softmax."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(2, n, 4, 8)).astype(np.float32)
               for n in (5, 6, 6))
    mask = rng.random((2, 1, 5, 6)) < 0.8
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    with pytest.MonkeyPatch.context() as mp:
        source, drawn = patch_dropout(mp, 1, nchw=False)
        want = fnn.dot_product_attention(
            *(jnp.asarray(a, jdt) for a in (q, k, v)), mask=mask,
            dropout_rng=jax.random.PRNGKey(0), dropout_rate=0.1,
            deterministic=False)
        with common.dropout_source(source(None)):
            got = zoo.dot_product_attention(
                *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                torch.from_numpy(mask), dropout_rate=0.1)
    assert drawn["port"] == drawn["jax"] == [((1, 1, 5, 6), 0.9)]
    assert got.dtype == tdt
    tol = FWD_TOL if dtype == "float32" else BF16_TOL
    assert _scaled_err(got.float().numpy(), np.asarray(want, np.float32)
                       ) <= tol
    plain = zoo.dot_product_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        torch.from_numpy(mask))
    assert not torch.equal(got, plain)


def test_attention_dropout_defaults_to_off():
    """The rate defaults to 0: SigLIP's and FakeNews's attention draw
    nothing in train mode and give their eval outputs bit for bit."""
    attn = zoo.MultiHeadDotProductAttention(16, 4)
    assert attn.dropout_rate == 0.0
    x = torch.randn(2, 5, 16)

    def refuse(*args):
        raise AssertionError("a draw at rate 0")

    with torch.no_grad(), common.dropout_source(refuse):
        trained = attn.train()(x)
        assert torch.equal(trained, attn.eval()(x))


def test_classifier_freezes_the_encoder():
    """``BertClassifier``: the encoder under ``torch.no_grad()`` gets no
    gradient and its dropouts still draw in train mode; the [CLS] head
    trains."""
    head = pbert.BertClassifier(5, num_layers=1, width=32, heads=4,
                                vocab_size=200).train()
    ids = torch.from_numpy(_ids())
    draws = []

    def source(shape, keep_prob, device):
        draws.append(shape)
        return torch.ones(shape, dtype=torch.bool)

    with common.dropout_source(source):
        head(ids).sum().backward()
    assert len(draws) == 4 and (1, 1, L, L) in draws
    for name, p in head.named_parameters():
        assert (p.grad is None) == name.startswith("model."), name
    with torch.no_grad():
        want = head.classifier(head.model.eval()(ids)[:, 0])
        assert torch.equal(head.eval()(ids), want)


def test_key_map_inverts_port_bert():
    """flax tree -> port -> the port's state_dict (HF ``BertModel``'s
    names) -> the JAX ``port_bert`` -> the same flax tree, bit for bit."""
    params = _flax_params()
    model = load_jax_variables(pbert.BertEncoder(**TINY), params, {})
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    back = port_bert(state, num_layers=2, num_heads=4)
    flat, tree = jax.tree_util.tree_flatten(params)
    flat_back, tree_back = jax.tree_util.tree_flatten(back)
    assert tree == tree_back
    for a, b in zip(flat, flat_back):
        assert a.shape == b.shape and np.array_equal(a, b)
    assert "encoder.layer.1.attention.output.LayerNorm.weight" in state


def test_full_geometry_matches_flax_shapes():
    """bert-base-uncased: every leaf of the flax tree (shapes from
    ``jax.eval_shape``) maps to the port's parameter of that shape; the
    same count on both sides."""
    shapes = jax.eval_shape(functools.partial(jbert.BertEncoder().init,
                                              train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 512), jnp.int32))["params"]
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    with torch.device("meta"):
        model = pbert.BertEncoder()
    named = dict(model.named_parameters())
    keys = jax_key_map(model)
    assert set(keys) == set(model.state_dict())
    for key, (_, path, kind) in keys.items():
        assert to_torch_layout(kind, get_leaf(zeros, path)).shape == tuple(
            named[key].shape), key
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert 1.08e8 < n_jax < 1.1e8


def test_default_init_follows_flax():
    """Without a checkpoint: lecun-normal kernels, zero biases, unit
    LayerNorm scales, N(0, 1 / width) word embeddings, N(0, 0.02) position
    and token-type tables, all drawn from the generator given."""
    geometry = dict(vocab_size=4000, width=256, num_layers=1, heads=4,
                    mlp_dim=512)
    model = pbert.BertEncoder(**geometry)
    common.init_weights(model, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert abs(float(sd["embeddings.word_embeddings.weight"].std())
               - 256 ** -0.5) < 2e-3
    assert abs(float(sd["embeddings.position_embeddings.weight"].std())
               - 0.02) < 1e-3
    assert abs(float(sd["embeddings.token_type_embeddings.weight"].std())
               - 0.02) < 3e-3
    query = sd["encoder.layer.0.attention.self.query.weight"]
    assert abs(float(query.std()) - 256 ** -0.5) < 3e-3
    assert float(query.abs().max()) <= 2 * 256 ** -0.5 / 0.8796257
    for key, value in sd.items():
        if key.endswith("bias"):
            assert not value.any(), key
        if "LayerNorm" in key and key.endswith("weight"):
            assert (value == 1).all(), key
    again = pbert.BertEncoder(**geometry)
    common.init_weights(again, torch.Generator().manual_seed(0))
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in sd.items())
