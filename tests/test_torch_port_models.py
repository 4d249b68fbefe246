"""The port's towers (``multimodal_clinical_tpu_torch/models``) held against
the JAX package's flax modules on the CPU, from the same weights.

The flax variables are initialised, handed over as numpy trees through
``load_jax_variables``, and both sides run the same numpy inputs: forward
in train and eval mode, input and parameter gradients, the BN running
buffers after one train forward (flax's biased variance), one bf16 forward,
and the round trip back through the JAX package's ``port_resnet_encoder``.
The switched encoder (``bn_fused=True, pool_kernel="pallas"``: the
BN-sums and stored-index max-pool paths, the JAX ones in interpret mode or
their plain sums) is held the same way, with the unbiased running
variance of ``FusedBatchNorm``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.models import zoo as jax_zoo
from multimodal_clinical_tpu.models.resnet import (
    ResNetEncoder as JaxResNetEncoder,
)
from multimodal_clinical_tpu.models.torch_port import port_resnet_encoder
from multimodal_clinical_tpu_torch.models.jax_weights import (
    get_leaf, jax_key_map, load_jax_variables, to_torch_layout,
)
from multimodal_clinical_tpu_torch.models.resnet import ResNetEncoder
from multimodal_clinical_tpu_torch.models.zoo import CremadFusionNet

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

WIDTH = 8
CLASSES = 5
# fp32 against fp32: the two conv libraries sum in another order, and
# train-mode BN divides by the standard deviation of as few as 4 values per
# channel in the last stage, which amplifies that difference to ~4e-5.
RTOL, ATOL = 1e-4, 1e-4
# Gradients sum many terms of both signs: fp32 rounding is relative to the
# largest terms, and train-mode BN over 4 values per channel (the video
# tower's last stage) cancels most of them.  Each gradient tensor is held
# to 3e-4 of its largest entry (measured up to 1.1e-4 of it).
GRAD_SCALED_TOL = 3e-4
# bf16 compute: each side's bf16 logits are themselves up to ~0.03 from its
# own fp32 logits at 64x64 inputs (8 mantissa bits at each cast point,
# amplified by train-mode BN over few values); the two sides round at
# different places.
BF16_ATOL = 0.05


def _assert_scaled_close(got, want, tol, name=""):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= tol * np.abs(want).max(), (name, err, np.abs(want).max())


def _assert_grads_match(tmod, jax_grads):
    named = dict(tmod.named_parameters())
    for key, (coll, path, kind) in jax_key_map(tmod).items():
        if coll == "params":
            _assert_scaled_close(
                named[key].grad.numpy(),
                to_torch_layout(kind, get_leaf(jax_grads, path)),
                GRAD_SCALED_TOL, key)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_vars(module, *inputs):
    # jitted: flax run op by op on the CPU takes several times longer
    variables = jax.jit(lambda key, *xs: module.init(key, *xs, train=False))(
        jax.random.PRNGKey(0), *[jnp.asarray(x) for x in inputs])
    return _np_tree(variables["params"]), _np_tree(variables["batch_stats"])


def _torch_model(model, params, stats):
    load_jax_variables(model, params, stats)
    return model.to(memory_format=torch.channels_last)


@pytest.fixture
def narrow_zoo(monkeypatch):
    """The JAX CremadFusionNet with WIDTH-wide towers."""
    monkeypatch.setattr(jax_zoo, "ResNetEncoder",
                        functools.partial(JaxResNetEncoder, width=WIDTH))
    return jax_zoo.CremadFusionNet


def _fusion_inputs(seed=0, size=32):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=(2, size + 8, size, 1)).astype(np.float32)
    x2 = rng.normal(size=(2, 2, size, size, 3)).astype(np.float32)
    return x1, x2


def _jax_reference(jmod, inputs, weights):
    """One flax pass for each mode over the same variables: train-mode
    outputs, updated batch_stats, and the gradients of
    sum(out_i * weights_i) with respect to params and inputs; eval-mode
    outputs."""
    params, stats = _jax_vars(jmod, *inputs)
    jin = [jnp.asarray(a) for a in inputs]

    def loss(p, *xin):
        out, mutated = jmod.apply({"params": p, "batch_stats": stats}, *xin,
                                  train=True, mutable=["batch_stats"])
        outs = out["logits"] if isinstance(out, dict) else [out]
        total = sum(jnp.sum(o * w) for o, w in zip(outs, weights))
        return total, (outs, mutated["batch_stats"])

    argnums = tuple(range(len(inputs) + 1))
    (_, (outs, new_stats)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=argnums, has_aux=True))(params, *jin)
    eval_out = jax.jit(lambda *xs: jmod.apply(
        {"params": params, "batch_stats": stats}, *xs, train=False))(*jin)
    eval_outs = eval_out["logits"] if isinstance(eval_out, dict) else [
        eval_out]
    return dict(params=params, stats=stats, train=_np_tree(list(outs)),
                new_stats=_np_tree(new_stats), grads=_np_tree(grads[0]),
                input_grads=_np_tree(list(grads[1:])),
                eval=_np_tree(list(eval_outs)))


@pytest.fixture(scope="module")
def encoder_case():
    x = np.random.default_rng(0).normal(size=(2, 40, 24, 1)).astype(
        np.float32)
    w = [np.random.default_rng(1).normal(size=(2, 2, 1, 8 * WIDTH)).astype(
        np.float32)]
    return (x,), w, _jax_reference(JaxResNetEncoder(width=WIDTH), (x,), w)


@pytest.fixture(scope="module")
def fusion_case():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_zoo, "ResNetEncoder",
                   functools.partial(JaxResNetEncoder, width=WIDTH))
        inputs = _fusion_inputs()
        w = [np.full((2, CLASSES), 1.0, np.float32),
             np.full((2, CLASSES), 2.0, np.float32)]
        return inputs, w, _jax_reference(
            jax_zoo.CremadFusionNet(num_classes=CLASSES), inputs, w)


def _make_torch(case_name, ref):
    model = (ResNetEncoder(1, width=WIDTH) if case_name == "encoder"
             else CremadFusionNet(CLASSES, width=WIDTH))
    return _torch_model(model, ref["params"], ref["stats"])


def _run_torch(model, inputs, train):
    model.train(train)
    out = model(*[torch.from_numpy(a) for a in inputs])
    return out["logits"] if isinstance(out, dict) else [out]


@pytest.mark.parametrize("case_name", ["encoder", "fusion"])
@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_jax(request, case_name, train):
    inputs, _, ref = request.getfixturevalue(case_name + "_case")
    model = _make_torch(case_name, ref)
    with torch.no_grad():
        got = _run_torch(model, inputs, train)
    want = ref["train" if train else "eval"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case_name", ["encoder", "fusion"])
def test_bn_running_buffers_after_train_forward(request, case_name):
    """momentum 0.1 towards the batch mean and the BIASED batch variance"""
    inputs, _, ref = request.getfixturevalue(case_name + "_case")
    model = _make_torch(case_name, ref)
    with torch.no_grad():
        _run_torch(model, inputs, True)
    sd = model.state_dict()
    checked = 0
    for key, (coll, path, kind) in jax_key_map(model).items():
        if coll == "batch_stats":
            np.testing.assert_allclose(
                sd[key].numpy(), get_leaf(ref["new_stats"], path),
                rtol=RTOL, atol=ATOL, err_msg=key)
            checked += 1
    towers = 1 if case_name == "encoder" else 2
    assert checked == towers * 2 * 20  # mean and var of 20 BNs per tower


@pytest.mark.parametrize("case_name", ["encoder", "fusion"])
def test_gradients_match_jax(request, case_name):
    inputs, weights, ref = request.getfixturevalue(case_name + "_case")
    model = _make_torch(case_name, ref)
    xs = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    model.train()
    out = model(*xs)
    outs = out["logits"] if isinstance(out, dict) else [out]
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, weights)
        ).backward()
    for x, gx in zip(xs, ref["input_grads"]):
        _assert_scaled_close(x.grad.numpy(), gx, GRAD_SCALED_TOL, "input")
    _assert_grads_match(model, ref["grads"])


def test_cremad_fusion_net_bf16_forward(narrow_zoo, fusion_case):
    """bf16 compute over the fp32 variables of ``fusion_case`` (parameter
    shapes do not depend on the input size), at 64x64 inputs."""
    _, _, ref = fusion_case
    params, stats = ref["params"], ref["stats"]
    x1, x2 = _fusion_inputs(seed=1, size=64)
    jmod = narrow_zoo(num_classes=CLASSES, dtype=jnp.bfloat16)
    want, _ = jax.jit(lambda *xs: jmod.apply(
        {"params": params, "batch_stats": stats}, *xs, train=True,
        mutable=["batch_stats"]))(jnp.asarray(x1), jnp.asarray(x2))
    tmod = _torch_model(
        CremadFusionNet(CLASSES, dtype=torch.bfloat16, width=WIDTH),
        params, stats)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x1), torch.from_numpy(x2))["logits"]
    for g, wnt in zip(got, want["logits"]):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(wnt, np.float32),
                                   rtol=0, atol=BF16_ATOL)


def test_state_dict_round_trips_through_port_resnet_encoder(fusion_case):
    _, _, ref = fusion_case
    tmod = _make_torch("fusion", ref)
    sd = tmod.state_dict()
    for tower in ("x1_model", "x2_model"):
        back_p, back_s = port_resnet_encoder(sd, tower + ".")
        jax.tree_util.tree_map(np.testing.assert_array_equal, back_p,
                               ref["params"][tower])
        jax.tree_util.tree_map(np.testing.assert_array_equal, back_s,
                               ref["stats"][tower])
    assert set(jax_key_map(tmod)) == set(sd)


SWITCHES = dict(bn_fused=True, pool_kernel="pallas")


@pytest.fixture(scope="module")
def switched_encoder_case():
    x = np.random.default_rng(3).normal(size=(2, 33, 37, 1)).astype(
        np.float32)
    w = [np.random.default_rng(4).normal(size=(2, 5, 5, 2 * WIDTH)).astype(
        np.float32)]
    jmod = JaxResNetEncoder(stage_sizes=(1, 1), width=WIDTH, **SWITCHES)
    return (x,), w, _jax_reference(jmod, (x,), w)


def _switched_encoder(ref):
    return _torch_model(ResNetEncoder(1, stage_sizes=(1, 1), width=WIDTH,
                                      **SWITCHES), ref["params"], ref["stats"])


@pytest.mark.parametrize("train", [True, False])
def test_switched_encoder_forward_matches_jax(switched_encoder_case, train):
    inputs, _, ref = switched_encoder_case
    with torch.no_grad():
        (got,) = _run_torch(_switched_encoder(ref), inputs, train)
    (want,) = ref["train" if train else "eval"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_switched_encoder_gradients_and_buffers_match_jax(
        switched_encoder_case):
    """One train-mode pass: input and parameter gradients, and the running
    buffers (momentum 0.1 towards the mean and the UNBIASED variance)."""
    inputs, weights, ref = switched_encoder_case
    model = _switched_encoder(ref)
    x = torch.from_numpy(inputs[0]).requires_grad_(True)
    model.train()
    (model(x) * torch.from_numpy(weights[0])).sum().backward()
    _assert_scaled_close(x.grad.numpy(), ref["input_grads"][0],
                         GRAD_SCALED_TOL, "input")
    _assert_grads_match(model, ref["grads"])
    sd = model.state_dict()
    stats = [(key, path) for key, (coll, path, _) in
             jax_key_map(model).items() if coll == "batch_stats"]
    assert len(stats) == 2 * 6  # mean and var of the 6 BNs of (1, 1)
    for key, path in stats:
        np.testing.assert_allclose(sd[key].numpy(),
                                   get_leaf(ref["new_stats"], path),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
