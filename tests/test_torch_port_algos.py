"""The port's OGM-GE, QMF and VICReg functions held against the JAX
package's on numpy-seeded inputs, on the CPU, in fp32.

Both sides compute the same fp32 formulas with their own reductions, so
values and gradients agree to a few ulps: each is held to 1e-6 relative,
with an absolute floor of 1e-6 of the tensor's largest entry for entries
near zero.  The OGM coefficient ``1 - tanh(.)`` is the exception: tanh
near 1 rounds to ulps of 1.0, so the coefficient is held to two of them
(2.4e-7) absolute, and a modulated gradient is held to 1e-6 relative
given each side's own coefficient (two ulps of 1.0 are 8.9e-7 of a
coefficient of 0.27).  The noise term's scale, each leaf's fp32 std, is
held the same way: each side's std to the float64 one within a bound of
the reduction's length (``_std_rtol``), and the modulated gradient given
each side's own std.  The History tables are written, not summed: they
must be equal bit for bit.

The JAX ``_modulate_leaf`` draws its noise with ``jax.random.normal``;
the tests replace that draw in the JAX module's namespace (as
``test_torch_port_probes.py`` replaces ``pallas_call``) by a queue of
numpy draws, one per 4-D leaf in the order the JAX walk visits them, and
give the port the same arrays, keyed by its parameter names through
``models/jax_weights.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.algos import ogm_ge as jax_ogm
from multimodal_clinical_tpu.algos import qmf as jax_qmf
from multimodal_clinical_tpu.algos import vicreg as jax_vicreg
from multimodal_clinical_tpu.models import zoo as jax_zoo
from multimodal_clinical_tpu.models.resnet import (
    ResNetEncoder as JaxResNetEncoder,
)
from multimodal_clinical_tpu_torch.algos import ogm_ge, qmf, vicreg
from multimodal_clinical_tpu_torch.models.jax_weights import (
    get_leaf, jax_key_map, to_torch_layout,
)
from multimodal_clinical_tpu_torch.models.zoo import CremadFusionNet

from torch_port_contract_harness import patch_ogm_normal

torch.set_num_threads(2)

RTOL = 1e-6
FLOOR = 1e-6  # of the tensor's largest entry
COEFF_ATOL = 2 * 2.0 ** -23
WIDTH, CLASSES = 4, 5


def _std_rtol(n: int) -> float:
    """Relative bound on an fp32 std of ``n`` entries against float64: the
    rounding of a length-n reduction grows as sqrt(n) ulps for random-sign
    errors, taken four times over.  For the largest leaf (9216 entries) it
    is 2.3e-5, under the 5.4e-5 by which ddof 0 would part from ddof 1."""
    return 4.0 * np.sqrt(n) * 2.0 ** -24


def _close(got, want, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=FLOOR * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _logits(seed, batch=8, bias=0.0):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=(batch, CLASSES)).astype(np.float32)
    x2 = rng.normal(size=(batch, CLASSES)).astype(np.float32)
    label = rng.integers(0, CLASSES, size=batch)
    x1[np.arange(batch), label] += bias  # make x1 the dominant modality
    return x1, x2, label


def _valid(batch, real):
    v = np.zeros(batch, np.float32)
    v[:real] = 1.0
    return v


# -- OGM-GE ----------------------------------------------------------------

@pytest.mark.parametrize("bias", [2.0, -2.0, 0.0])
@pytest.mark.parametrize("real", [None, 5])
def test_ogm_coefficients_match_jax(bias, real):
    x1, x2, label = _logits(1, bias=bias)
    valid = None if real is None else _valid(8, real)
    got = ogm_ge.ogm_coefficients(
        _t(x1), _t(x2), _t(label), 0.8, None if valid is None else _t(valid))
    want = jax_ogm.ogm_coefficients(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(label), 0.8,
        None if valid is None else jnp.asarray(valid))
    for g, w in zip(got, want):
        assert g.shape == ()
        np.testing.assert_allclose(float(g), float(w), rtol=0,
                                   atol=COEFF_ATOL)
    # exactly one modality is suppressed
    assert sorted(float(c) == 1.0 for c in got) == [False, True]


@pytest.fixture(scope="module")
def nets():
    """A full-depth CremadFusionNet on each side (width 4), the JAX
    parameter tree, and the torch key map."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_zoo, "ResNetEncoder",
                   functools.partial(JaxResNetEncoder, width=WIDTH))
        module = jax_zoo.CremadFusionNet(CLASSES)
        variables = jax.jit(functools.partial(module.init, train=False))(
            jax.random.PRNGKey(0), jnp.zeros((2, 33, 40, 1)),
            jnp.zeros((2, 1, 32, 32, 3)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    model = CremadFusionNet(CLASSES, width=WIDTH)
    keys = {k: v for k, v in jax_key_map(model).items() if v[0] == "params"}
    return dict(params=params, model=model, keys=keys)


def _four_d_leaves(tree, encoder_keys=jax_ogm.DEFAULT_ENCODER_KEYS):
    """Paths of the JAX walk's 4-D leaves, in the order it visits them."""
    out = []
    for key in encoder_keys:
        flat, _ = jax.tree_util.tree_flatten_with_path(tree[key])
        out += [(key,) + tuple(p.key for p in path)
                for path, leaf in flat if leaf.ndim == 4]
    return out


def test_modulated_parameters_are_the_jax_4d_leaves(nets):
    """The port walks exactly the JAX walk's leaves, name by name, in the
    same order: every conv weight of the two towers; no BN scale or bias,
    no classifier."""
    by_path = {path: name for name, (_, path, _) in nets["keys"].items()}
    jax_order = [by_path[p] for p in _four_d_leaves(nets["params"])]
    port = [name for _, name, _ in ogm_ge.modulated_parameters(nets["model"])]
    assert sorted(port) == sorted(jax_order)
    assert len(port) == 2 * 20  # the conv weights of two ResNet18 towers
    assert all(name.endswith("weight") and "bn" not in name
               and "classifier" not in name for name in port)


@pytest.mark.parametrize("modulation", ogm_ge.MODULATION_MODES)
@pytest.mark.parametrize("bias", [0.7, -0.7])
def test_modulate_gradients_matches_jax(nets, monkeypatch, modulation, bias):
    params, model, keys = nets["params"], nets["model"], nets["keys"]
    rng = np.random.default_rng(7)
    grads = jax.tree_util.tree_map(
        lambda p: rng.normal(scale=1e-2, size=p.shape).astype(np.float32),
        params)
    by_path = {path: name for name, (_, path, _) in keys.items()}
    order = _four_d_leaves(params)
    noise = {path: rng.normal(size=get_leaf(params, path).shape).astype(
        np.float32) for path in order}
    queue = list(order)

    def normal(key, shape, dtype=jnp.float32):
        path = queue.pop(0)
        assert tuple(shape) == noise[path].shape, path
        return jnp.asarray(noise[path], dtype)

    patch_ogm_normal(monkeypatch, normal)
    x1, x2, label = _logits(3, bias=bias)
    valid = _valid(8, 6)
    want = jax_ogm.modulate_gradients(
        jax.tree_util.tree_map(jnp.asarray, grads), jnp.asarray(x1),
        jnp.asarray(x2), jnp.asarray(label), jax.random.PRNGKey(0),
        alpha=0.8, modulation=modulation, valid=jnp.asarray(valid))
    assert not queue or modulation == "OGM"

    named = dict(model.named_parameters())
    for name, (_, path, kind) in keys.items():
        named[name].grad = _t(to_torch_layout(kind, get_leaf(grads, path)))
    port_noise = {by_path[p]: _t(to_torch_layout("conv", a))
                  for p, a in noise.items()}
    ogm_ge.modulate_gradients(
        model, _t(x1), _t(x2), _t(label),
        lambda name, g: port_noise[name], alpha=0.8,
        modulation=modulation, valid=_t(valid))
    # each side's coefficient, held to COEFF_ATOL; the gradients are then
    # held to RTOL given each side's own: JAX's modulated leaves moved to
    # the port's coefficient in float64 (the noise term does not depend on
    # it), so a coefficient an ulp or two apart is not amplified into the
    # gradient's relative bound
    coeffs = [(float(c), float(jc)) for c, jc in zip(
        ogm_ge.ogm_coefficients(_t(x1), _t(x2), _t(label), 0.8, _t(valid)),
        jax_ogm.ogm_coefficients(jnp.asarray(x1), jnp.asarray(x2),
                                 jnp.asarray(label), 0.8,
                                 jnp.asarray(valid)))]
    for c, jc in coeffs:
        assert abs(c - jc) <= COEFF_ATOL, coeffs
    # likewise each side's noise scale, the leaf's fp32 std (ddof 1): each
    # held to the float64 std within _std_rtol of its length, then JAX's
    # noise term moved onto the port's std in float64, so a last-bit
    # difference in the two reductions is not amplified by a noise draw
    # into the gradient's relative bound
    stds = {}
    if modulation != "OGM":
        for path in order:
            leaf = get_leaf(grads, path)
            std64 = np.std(leaf.astype(np.float64), ddof=1)
            port = float(_t(to_torch_layout("conv", leaf)).flatten().std())
            jstd = float(jnp.std(jnp.asarray(leaf), ddof=1))
            for side, s in (("port", port), ("jax", jstd)):
                assert abs(s - std64) <= _std_rtol(leaf.size) * std64, (
                    path, side, s, std64)
            stds[path] = (port, jstd)
    for name, (_, path, kind) in keys.items():
        got = named[name].grad
        ref = to_torch_layout(kind, get_leaf(want, path))
        if got.ndim == 4 and modulation != "noise":
            c, jc = coeffs[jax_ogm.DEFAULT_ENCODER_KEYS.index(path[0])]
            given = to_torch_layout(kind, get_leaf(grads, path))
            ref = ref.astype(np.float64) + given.astype(np.float64) * (
                c - jc)
        if path in stds:
            port, jstd = stds[path]
            ref = ref.astype(np.float64) + to_torch_layout(
                "conv", noise[path]).astype(np.float64) * (port - jstd)
        _close(got, ref, name)
        if len(path) and path[-1] != "kernel" or got.ndim != 4:
            # not modulated: bit-equal to the gradient given
            assert np.array_equal(
                got.numpy(), to_torch_layout(kind, get_leaf(grads, path))), name


def test_modulate_gradients_refuses_a_bad_mode_or_missing_noise(nets):
    x1, x2, label = _logits(0)
    args = (nets["model"], _t(x1), _t(x2), _t(label))
    with pytest.raises(ValueError, match="modulation must be"):
        ogm_ge.modulate_gradients(*args, modulation="nosuch")
    with pytest.raises(ValueError, match="noise source"):
        ogm_ge.modulate_gradients(*args, modulation="OGM_GE")


def test_device_noise_is_a_function_of_seed_and_step():
    g = torch.zeros(3, 4, 2, 2)
    draw = lambda seed, step: ogm_ge.device_noise(seed, step)("w", g)
    assert torch.equal(draw(5, 3), draw(5, 3))
    assert not torch.equal(draw(5, 3), draw(5, 4))
    assert not torch.equal(draw(5, 3), draw(6, 3))
    source = ogm_ge.device_noise(5, 3)
    first, second = source("a", g), source("b", g)
    assert not torch.equal(first, second)  # one stream, drawn in order
    assert first.dtype == torch.float32 and first.shape == g.shape


# -- QMF ------------------------------------------------------------------

def _df_inputs(seed, m=2, b=6):
    rng = np.random.default_rng(seed)
    return (rng.normal(scale=3.0, size=(m, b, CLASSES)).astype(np.float32),
            rng.normal(size=(b, CLASSES)).astype(np.float32),
            rng.normal(size=(m, b)).astype(np.float32))


def test_df_matches_jax_values_and_gradients():
    x, wf, wc = _df_inputs(0)

    def jax_obj(x):
        fused, conf = jax_qmf.df(x)
        return jnp.sum(fused * wf) + jnp.sum(conf * wc), (fused, conf)

    (_, (jfused, jconf)), jgrad = jax.value_and_grad(jax_obj, has_aux=True)(
        jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    fused, conf = qmf.df(xt)
    ((fused * _t(wf)).sum() + (conf * _t(wc)).sum()).backward()
    _close(fused, jfused, "fused")
    _close(conf, jconf, "conf")
    _close(xt.grad, jgrad, "grad")


def _tables(seed, m=2, n=12):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 2.0, size=(m, n)).astype(np.float32),
            rng.normal(size=(m, n)).astype(np.float32))


def _padded_idx():
    """Five real rows, the last repeated three times as the loader pads
    (``data/loader.py::_pad_batch``): ``idx`` 3 appears four times."""
    idx = np.array([7, 0, 11, 5, 3, 3, 3, 3], np.int64)
    return idx, _valid(8, 5)


@pytest.mark.parametrize("padded", [False, True])
def test_history_update_matches_jax(padded):
    corr, conf = _tables(1)
    if padded:
        idx, valid = _padded_idx()
    else:
        idx, valid = np.array([7, 0, 11, 5, 3, 9, 2, 4]), None
    rng = np.random.default_rng(2)
    batch_conf = rng.normal(size=8).astype(np.float32)
    # the pad rows carry other confidences than the row they repeat: a
    # pad write that won the scatter would show
    loss = np.float32(1.37)
    got = qmf.history_update(
        _t(corr[0]), _t(conf[0]), _t(idx), _t(loss), _t(batch_conf),
        None if valid is None else _t(valid))
    want = jax_qmf.history_update(
        jnp.asarray(corr[0]), jnp.asarray(conf[0]),
        jnp.asarray(idx.astype(np.int32)), jnp.asarray(loss),
        jnp.asarray(batch_conf), None if valid is None else jnp.asarray(valid))
    for g, w in zip(got, want):
        assert g.shape == (12,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    real = idx if valid is None else idx[valid.astype(bool)]
    untouched = np.setdiff1d(np.arange(12), real)
    np.testing.assert_array_equal(got[0].numpy()[untouched],
                                  corr[0][untouched])
    np.testing.assert_array_equal(got[1].numpy()[untouched],
                                  conf[0][untouched])
    # the last real row's confidence, not a pad row's
    assert got[1][3] == batch_conf[4]
    # the inputs are left as they were
    assert np.array_equal(corr[0], _tables(1)[0][0])


def test_history_update_keeps_the_last_row_of_a_drawn_twice_idx():
    """The train sampler draws with replacement, so a valid ``idx`` may
    appear twice in a batch (here 5 and 3, one of the 3s padding): the
    last valid row of each writes the confidence, as the JAX scatter on
    the CPU applies the rows in order."""
    corr, conf = _tables(4)
    idx = np.array([5, 0, 3, 5, 11, 3, 3, 3], np.int64)
    valid = _valid(8, 6)
    batch_conf = np.random.default_rng(5).normal(size=8).astype(np.float32)
    loss = np.float32(0.61)
    got = qmf.history_update(_t(corr[1]), _t(conf[1]), _t(idx), _t(loss),
                             _t(batch_conf), _t(valid))
    want = jax_qmf.history_update(
        jnp.asarray(corr[1]), jnp.asarray(conf[1]),
        jnp.asarray(idx.astype(np.int32)), jnp.asarray(loss),
        jnp.asarray(batch_conf), jnp.asarray(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1][5] == batch_conf[3] and got[1][3] == batch_conf[5]
    # the correctness EMA reads the table before the batch: once per idx
    assert got[0][5] == np.float32(0.9) * corr[1][5] + np.float32(0.1) * loss


def test_target_margin_matches_jax():
    corr, _ = _tables(3)
    idx1 = np.array([0, 4, 7, 2, 9])
    idx2 = np.roll(idx1, -1)
    got = qmf.target_margin(_t(corr[1]), _t(idx1), _t(idx2))
    want = jax_qmf.target_margin(jnp.asarray(corr[1]), jnp.asarray(idx1),
                                 jnp.asarray(idx2))
    for g, w in zip(got, want):
        _close(g, w)
    # equal correctness gives target 0
    tied = corr[1].copy()
    tied[4] = tied[0]
    tgt, _ = qmf.target_margin(_t(tied), _t(idx1), _t(idx2))
    assert float(tgt[0]) == 0.0
    assert set(np.unique(tgt.numpy())) <= {-1.0, 0.0, 1.0}


@pytest.mark.parametrize("padded", [False, True])
def test_reg_loss_matches_jax_values_and_gradients(padded):
    corr, _ = _tables(4)
    if padded:
        idx, valid = _padded_idx()
    else:
        idx, valid = np.array([7, 0, 11, 5, 3, 9, 2, 4]), None
    conf = np.random.default_rng(5).normal(size=(2, 8)).astype(np.float32)
    jvalid = None if valid is None else jnp.asarray(valid)
    jloss, jgrad = jax.value_and_grad(
        lambda c: jax_qmf.reg_loss(c, jnp.asarray(idx.astype(np.int32)),
                                   jnp.asarray(corr), jvalid))(
        jnp.asarray(conf))
    ct = _t(conf).requires_grad_(True)
    loss = qmf.reg_loss(ct, _t(idx), _t(corr),
                        None if valid is None else _t(valid))
    loss.backward()
    assert float(jloss) > 0
    _close(loss, jloss, "loss")
    _close(ct.grad, jgrad, "grad")
    if padded:
        # pad rows take no part: their confidences get no gradient
        assert not ct.grad[:, 5:].any()


def test_init_history_is_two_zero_tables():
    corr, conf = qmf.init_history(2, 9)
    assert corr.shape == conf.shape == (2, 9)
    assert corr.dtype == torch.float32 and not corr.any() and not conf.any()
    assert corr.data_ptr() != conf.data_ptr()


# -- VICReg -----------------------------------------------------------------

@pytest.mark.parametrize("padded", [False, True])
def test_vicreg_loss_matches_jax_values_and_gradients(padded):
    rng = np.random.default_rng(6)
    za = rng.normal(scale=0.7, size=(8, 6)).astype(np.float32)
    zb = (za + rng.normal(scale=0.3, size=(8, 6))).astype(np.float32)
    valid = _valid(8, 5) if padded else None
    if padded:
        za[5:], zb[5:] = za[4], zb[4]  # the loader's padding
    jvalid = None if valid is None else jnp.asarray(valid)
    jloss, jgrads = jax.value_and_grad(
        lambda a, b: jax_vicreg.vicreg_loss(a, b, jvalid), argnums=(0, 1))(
        jnp.asarray(za), jnp.asarray(zb))
    ta, tb = (_t(za).requires_grad_(True), _t(zb).requires_grad_(True))
    loss = vicreg.vicreg_loss(ta, tb, None if valid is None else _t(valid))
    loss.backward()
    _close(loss, jloss, "loss")
    _close(ta.grad, jgrads[0], "grad a")
    _close(tb.grad, jgrads[1], "grad b")
    if padded:
        # the padded batch gives the reference's value on its 5 real rows
        short = vicreg.vicreg_loss(_t(za[:5]), _t(zb[:5]))
        _close(loss, short.detach().numpy(), "short batch")
