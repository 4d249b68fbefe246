"""Food101's SigLIP towers in the port (``models/siglip.py``, the attention
of ``models/zoo.py``, ``models/mlp.py::HeadMLP`` and the weight loaders)
against the JAX package's flax modules on the CPU.

Geometry: ``tests/test_siglip_parity.py``'s tiny SigLIP (width 64, 2
layers, 2 heads, MLP 128, 32 x 32 images, 16 tokens, vocabulary 1000),
the flax tree carried across by ``models/jax_weights.py``.

Tolerances: fp32 forwards and every parameter gradient within 1e-5 of
each tensor's largest entry (the two frameworks sum the same products in
another order; ``TextTransformer``'s bound in
``test_torch_port_fakenews_towers.py``).  The key projections' biases
have a gradient that is zero in exact arithmetic (the softmax over the
keys is shift invariant): both sides' are held below 1e-6 instead.  bf16
forwards within 2^-6 of the largest entry: bf16 keeps 8 bits, and the
two frameworks round the softmax, the GELU and the sums at different
points.  Weight loading is bit-exact.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from multimodal_clinical_tpu.models import mlp as jax_mlp
from multimodal_clinical_tpu.models import siglip as jsig
from multimodal_clinical_tpu_torch.models import common, pretrained, zoo
from multimodal_clinical_tpu_torch.models import siglip as psig
from multimodal_clinical_tpu_torch.models.jax_weights import (
    get_leaf, jax_key_map, load_jax_variables, to_torch_layout,
)
from multimodal_clinical_tpu_torch.models.mlp import HeadMLP
from torch_port_benchmark_harness import SIGLIP_TINY, patch_dropout

torch.set_num_threads(2)

FWD_TOL = GRAD_TOL = 1e-5
BF16_TOL = 2.0 ** -6
ROUNDING_GRAD = 1e-6
B = 3
# the JAX port's geometry keywords for the tiny towers
JAX_PORT_GEOMETRY = dict(width=SIGLIP_TINY["width"],
                         heads=SIGLIP_TINY["heads"],
                         layers=SIGLIP_TINY["layers"])
to_np = functools.partial(jax.tree_util.tree_map, np.asarray)


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, SIGLIP_TINY["vocab"],
                       (B, SIGLIP_TINY["text_len"])).astype(np.int32)
    size = SIGLIP_TINY["image_size"]
    pixels = rng.uniform(-1, 1, (B, size, size, 3)).astype(np.float32)
    return ids, pixels


@functools.lru_cache(maxsize=None)
def _flax_params():
    """The tiny flax SigLIPModel's parameters (numpy), one jitted init."""
    ids, pixels = _inputs()
    variables = jax.jit(jsig.SigLIPModel(**SIGLIP_TINY).init)(
        jax.random.PRNGKey(1), jnp.asarray(ids), jnp.asarray(pixels))
    return to_np(variables["params"])


def _pair(dtype):
    """(flax SigLIPModel, the port's with the flax weights) in ``dtype``."""
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    model = psig.SigLIPModel(dtype=tdt, **SIGLIP_TINY)
    load_jax_variables(model, _flax_params(), {})
    return jsig.SigLIPModel(dtype=jdt, **SIGLIP_TINY), model


def _tower(jmodel, part):
    """The flax tower ``part`` of ``jmodel`` as a module of its own."""
    geometry = dict(SIGLIP_TINY)
    drop = (("patch", "image_size") if part == "text_model"
            else ("text_len", "vocab"))
    for key in drop:
        geometry.pop(key)
    tower = (jsig.SigLIPTextTower if part == "text_model"
             else jsig.SigLIPVisionTower)
    return tower(dtype=jmodel.dtype, **geometry)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("part", ["text_model", "vision_model", "both"])
def test_forward_matches_flax(part, dtype):
    """Each tower (the vision tower with its MAP head) in the compute
    dtype, and SigLIPModel's pair, normalised in fp32."""
    jmodel, model = _pair(dtype)
    ids, pixels = _inputs()
    params = _flax_params()
    with torch.no_grad():
        if part == "both":
            want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(ids),
                                         jnp.asarray(pixels))
            got = model(torch.from_numpy(ids), torch.from_numpy(pixels))
            for g in got:
                torch.testing.assert_close(g.norm(dim=-1), torch.ones(B))
        else:
            x = ids if part == "text_model" else pixels
            want = [jax.jit(_tower(jmodel, part).apply)(
                {"params": params[part]}, jnp.asarray(x))]
            got = [getattr(model, part)(torch.from_numpy(x))]
    tol = FWD_TOL if dtype == "float32" else BF16_TOL
    for g, w in zip(got, want):
        assert str(g.dtype) == f"torch.{np.asarray(w).dtype}", part
        assert (g.dtype == torch.float32) == (dtype == "float32"
                                              or part == "both")
        assert g.shape == (B, SIGLIP_TINY["width"])
        assert _scaled_err(g.float().numpy(), w) <= tol, (part, dtype)


@pytest.mark.parametrize("part", ["text_model", "vision_model"])
def test_gradients_match_flax(part):
    """fp32: every parameter's gradient of a fixed projection of the
    tower's output."""
    jmodel, model = _pair("float32")
    ids, pixels = _inputs()
    x = ids if part == "text_model" else pixels
    proj = np.random.default_rng(5).normal(
        size=(B, SIGLIP_TINY["width"])).astype(np.float32)
    tower = _tower(jmodel, part)
    grads = jax.jit(jax.grad(lambda p: (tower.apply(
        {"params": p}, jnp.asarray(x)) * proj).sum()))(_flax_params()[part])
    (getattr(model, part)(torch.from_numpy(x))
     * torch.from_numpy(proj)).sum().backward()
    named = dict(model.named_parameters())
    checked = 0
    for key, (_, path, kind) in jax_key_map(model).items():
        if not key.startswith(part):
            continue
        got = named[key].grad.numpy()
        want = to_torch_layout(kind, get_leaf({part: grads}, path))
        if key.endswith("k_proj.bias"):
            assert np.abs(got).max() <= ROUNDING_GRAD, key
            assert np.abs(want).max() <= ROUNDING_GRAD, key
        else:
            assert _scaled_err(got, want) <= GRAD_TOL, key
        checked += 1
    assert checked == sum(1 for k in named if k.startswith(part))


def test_cross_attention_matches_flax():
    """The attention with a separate key/value input and a mask (one
    query attending to nothing), fp32, against flax's
    ``MultiHeadDotProductAttention``; FakeNews's ``SelfAttention`` is its
    self-attention case under a key-padding mask, bit for bit."""
    rng = np.random.default_rng(3)
    q_in = rng.normal(size=(2, 3, 16)).astype(np.float32)
    kv_in = rng.normal(size=(2, 5, 16)).astype(np.float32)
    mask = rng.random((2, 1, 3, 5)) < 0.7
    mask[1, :, 2] = False
    jattn = fnn.MultiHeadDotProductAttention(num_heads=4)
    variables = jattn.init(jax.random.PRNGKey(0), q_in, kv_in)
    want = jattn.apply(variables, q_in, kv_in, mask=mask)
    p = to_np(variables["params"])
    attn = zoo.MultiHeadDotProductAttention(16, 4)
    state = {}
    for name in ("query", "key", "value", "out"):
        out = name == "out"
        state[name + ".weight"] = to_torch_layout(
            "heads_out" if out else "heads_in", p[name]["kernel"])
        state[name + ".bias"] = to_torch_layout(
            "vector" if out else "flat", p[name]["bias"])
    attn.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in state.items()})
    with torch.no_grad():
        got = attn(torch.from_numpy(q_in), torch.from_numpy(kv_in),
                   torch.from_numpy(mask))
        assert _scaled_err(got.numpy(), want) <= FWD_TOL
        self_attn = zoo.SelfAttention(16, 4)
        self_attn.load_state_dict(attn.state_dict())
        x = torch.from_numpy(q_in)
        pad = torch.tensor([[True, True, False], [False, False, False]])
        assert torch.equal(self_attn(x, pad),
                           attn(x, mask=pad[:, None, None, :]))


@pytest.mark.parametrize("train", [True, False])
def test_head_mlp_matches_flax(train):
    """768 -> 512 -> 512 -> 101 with ReLU and the injected dropout masks
    after each hidden layer (identity in eval mode)."""
    x = np.random.default_rng(4).normal(size=(5, 768)).astype(np.float32)
    jhead = jax_mlp.HeadMLP(101)
    variables = jax.jit(functools.partial(jhead.init, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x))
    head = load_jax_variables(HeadMLP(101), to_np(variables["params"]), {})
    head.train(train)
    with pytest.MonkeyPatch.context() as mp:
        source, drawn = patch_dropout(mp, 2)
        want = jhead.apply(variables, jnp.asarray(x), train=train,
                           rngs={"dropout": jax.random.PRNGKey(1)})
        with torch.no_grad(), common.dropout_source(source(None)):
            got = head(torch.from_numpy(x))
    assert drawn["port"] == drawn["jax"] == (
        [((5, 512), 0.8)] * 2 if train else [])
    assert _scaled_err(got.numpy(), want) <= FWD_TOL
    assert list(head.flax_names) == ["mlp.0", "mlp.3", "mlp.6"]


def test_key_map_inverts_port_siglip_state_dict():
    """flax tree -> port -> the port's state_dict (HF's names) -> the JAX
    ``port_siglip_state_dict`` -> the same flax tree, bit for bit."""
    params = _flax_params()
    model = load_jax_variables(psig.SigLIPModel(**SIGLIP_TINY), params, {})
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    back = jsig.port_siglip_state_dict(state, params, **JAX_PORT_GEOMETRY)
    flat, tree = jax.tree_util.tree_flatten(params)
    flat_back, tree_back = jax.tree_util.tree_flatten(back)
    assert tree == tree_back
    for a, b in zip(flat, flat_back):
        assert a.shape == b.shape and np.array_equal(a, b)
    assert "vision_model.head.attention.in_proj_weight" in state
    assert "text_model.encoder.layers.1.self_attn.q_proj.weight" in state


def test_full_geometry_matches_flax_shapes():
    """siglip-base-patch16-224: every leaf of the flax tree (its shapes
    from ``jax.eval_shape``) maps to the port's parameter of that shape;
    the same count on both sides."""
    shapes = jax.eval_shape(jsig.SigLIPModel().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64), jnp.int32),
                            jnp.zeros((1, 224, 224, 3)))["params"]
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    with torch.device("meta"):
        model = psig.SigLIPModel()
    named = dict(model.named_parameters())
    keys = jax_key_map(model)
    assert set(keys) == set(model.state_dict())
    for key, (_, path, kind) in keys.items():
        assert to_torch_layout(kind, get_leaf(zeros, path)).shape == tuple(
            named[key].shape), key
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert 2e8 < n_jax < 2.1e8


def _hf_state(seed=9):
    """A seeded HF ``SiglipModel``-layout state_dict of the tiny geometry,
    with the keys the port ignores."""
    torch.manual_seed(seed)
    model = psig.SigLIPModel(**SIGLIP_TINY)
    state = {k: torch.randn(v.shape) * 0.1
             for k, v in model.state_dict().items()}
    state["logit_scale"] = torch.tensor([2.3])
    state["logit_bias"] = torch.tensor([-10.0])
    state["text_model.embeddings.position_ids"] = torch.arange(
        SIGLIP_TINY["text_len"])[None]
    return state


@pytest.mark.parametrize("fmt", ["pytorch_model.bin", "model.safetensors"])
def test_hf_checkpoint_loads_like_jax(tmp_path, fmt):
    """The same checkpoint loaded by the port and by the JAX
    ``load_hf_siglip_params`` (its geometry keywords set to the tiny
    towers'): the weights as stored, equal fp32 forwards."""
    state = _hf_state()
    if fmt.endswith(".bin"):
        torch.save(state, tmp_path / fmt)
    else:
        from safetensors.torch import save_file

        save_file({k: v.contiguous() for k, v in state.items()},
                  str(tmp_path / fmt))
    model = psig.load_hf_siglip_params(
        str(tmp_path), psig.SigLIPModel(**SIGLIP_TINY))
    for key, value in model.state_dict().items():
        assert torch.equal(value, state[key]), key
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsig, "port_siglip_state_dict", functools.partial(
            jsig.port_siglip_state_dict, **JAX_PORT_GEOMETRY))
        params = jsig.load_hf_siglip_params(str(tmp_path), _flax_params())
    ids, pixels = _inputs(2)
    want = jsig.SigLIPModel(**SIGLIP_TINY).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(pixels))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(pixels))
    for g, w in zip(got, want):
        assert _scaled_err(g.numpy(), w) <= FWD_TOL


def test_hf_checkpoint_refuses_a_missing_key_or_a_wrong_shape(tmp_path):
    state = _hf_state()
    model = psig.SigLIPModel(**SIGLIP_TINY)
    missing = {k: v for k, v in state.items()
               if k != "vision_model.head.probe"}
    with pytest.raises(KeyError, match="vision_model.head.probe"):
        psig.port_siglip_state_dict(missing, model)
    wrong = dict(state)
    wrong["text_model.head.weight"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="text_model.head.weight"):
        psig.port_siglip_state_dict(wrong, model)
    with pytest.raises(FileNotFoundError, match="no model.safetensors"):
        psig.load_hf_siglip_params(str(tmp_path), model)


@pytest.mark.parametrize("dtype", ["F32", "F16", "I64", "BF16"])
def test_safetensors_reader_matches_safetensors(tmp_path, dtype):
    """The port's reader against ``safetensors``' own (BF16 widened to
    fp32 and held against ``safetensors.torch``, as numpy has no bf16); a
    scalar and an empty tensor included."""
    from safetensors.numpy import load_file
    from safetensors.torch import save_file

    rng = np.random.default_rng(6)
    make = {"F32": lambda s: torch.from_numpy(
                rng.normal(size=s).astype(np.float32)),
            "F16": lambda s: torch.from_numpy(
                rng.normal(size=s).astype(np.float16)),
            "I64": lambda s: torch.from_numpy(rng.integers(-9, 9, s)),
            "BF16": lambda s: torch.randn(s).bfloat16()}[dtype]
    tensors = {"a": make((3, 5)), "b.c": make((7,)), "scalar": make(()),
               "empty": make((0, 4)), "odd": make((3,))}
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = pretrained.read_safetensors(path)
    assert set(got) == set(tensors)
    want = ({k: v.float().numpy() for k, v in tensors.items()}
            if dtype == "BF16" else load_file(path))
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_torch_state_dict_reads_safetensors_without_the_package(tmp_path):
    """``pretrained.torch_state_dict`` reads ``.safetensors`` (a file or
    an HF snapshot directory) with the port's reader, so no
    ``safetensors`` package is needed."""
    from safetensors.torch import save_file

    state = {"w": torch.randn(4, 3), "n": torch.tensor(3)}
    save_file(state, str(tmp_path / "model.safetensors"))
    with pytest.MonkeyPatch.context() as mp:
        for name in ("safetensors", "safetensors.numpy", "safetensors.torch"):
            mp.setitem(sys.modules, name, None)
        for path in (tmp_path, tmp_path / "model.safetensors"):
            got = pretrained.torch_state_dict(str(path))
            assert set(got) == {"w", "n"}
            np.testing.assert_array_equal(got["w"], state["w"].numpy())
            assert got["n"] == 3


def test_default_init_follows_flax():
    """Without a checkpoint: lecun-normal kernels, zero biases, unit
    LayerNorm scales, N(0, 0.02) positions, N(0, 1 / width) token table,
    a xavier-uniform probe, all drawn from the generator given."""
    geometry = dict(width=256, layers=1, heads=4, mlp_dim=512,
                    image_size=64, text_len=64, vocab=4000)
    model = psig.SigLIPModel(**geometry)
    common.init_weights(model, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    text, vision = "text_model.", "vision_model."
    assert abs(float(sd[text + "embeddings.token_embedding.weight"].std())
               - 256 ** -0.5) < 2e-3
    for tower in (text, vision):
        pos = sd[tower + "embeddings.position_embedding.weight"]
        assert abs(float(pos.std()) - 0.02) < 1e-3
        fc1 = sd[tower + "encoder.layers.0.mlp.fc1.weight"]
        assert abs(float(fc1.std()) - 256 ** -0.5) < 2e-3
        # truncated at two standard deviations of the uncorrected normal
        assert float(fc1.abs().max()) <= 2 * 256 ** -0.5 / 0.8796257
    patch = sd[vision + "embeddings.patch_embedding.weight"]
    assert abs(float(patch.std()) - 768 ** -0.5) < 2e-3
    probe = sd[vision + "head.probe"]
    limit = (6 / 257) ** 0.5
    assert 0.8 * limit < float(probe.abs().max()) <= limit
    for key, value in sd.items():
        if key.endswith("bias"):
            assert not value.any(), key
        if "norm" in key and key.endswith("weight"):
            assert (value == 1).all(), key
    again = psig.SigLIPModel(**geometry)
    common.init_weights(again, torch.Generator().manual_seed(0))
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in sd.items())
