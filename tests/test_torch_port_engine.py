"""The port's engine math (``engine/contracts``, ``algos/ema``,
``engine/state``, ``engine/spec``) held against the JAX package on the CPU.

Inputs come from numpy with a fixed seed and go through both sides.  All of
it is fp32 elementwise work and short reductions, so the tolerances are a
few fp32 ulps of the values compared.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_clinical_tpu.algos import ema as jax_ema
from multimodal_clinical_tpu.engine import contracts as jax_contracts
from multimodal_clinical_tpu.engine import state as jax_state
from multimodal_clinical_tpu_torch.algos import ema
from multimodal_clinical_tpu_torch.engine import contracts, state
from multimodal_clinical_tpu_torch.engine.spec import ModelSpec, resolve_dtype
from multimodal_clinical_tpu_torch.models.common import TorchDense

torch.set_num_threads(2)

# fp32 softmax/log/mean over a handful of classes: a few ulps apart
RTOL, ATOL = 1e-6, 1e-6


def _logits(seed, b=6, c=7, m=2):
    rng = np.random.default_rng(seed)
    logits = [rng.normal(scale=3.0, size=(b, c)).astype(np.float32)
              for _ in range(m)]
    label = rng.integers(0, c, size=b)
    valid = np.array([1, 1, 0, 1, 1, 0][:b], np.float32)
    return logits, label, valid


@pytest.mark.parametrize("name", ["fuse_probas", "fuse_logits"])
@pytest.mark.parametrize("seed", [0, 1])
def test_fusion_loss_and_accuracy_match_jax(name, seed):
    logits, label, valid = _logits(seed)
    fused = getattr(contracts, name)([torch.from_numpy(l) for l in logits])
    jfused = getattr(jax_contracts, name)([jnp.asarray(l) for l in logits])
    np.testing.assert_allclose(fused.numpy(), np.asarray(jfused),
                               rtol=RTOL, atol=ATOL)
    tl, jl = torch.from_numpy(label), jnp.asarray(label.astype(np.int32))
    for v in (None, valid):
        tv = None if v is None else torch.from_numpy(v)
        jv = None if v is None else jnp.asarray(v)
        np.testing.assert_allclose(
            float(contracts.cross_entropy(fused, tl, tv)),
            float(jax_contracts.cross_entropy(jfused, jl, jv)),
            rtol=RTOL, atol=ATOL)
        assert float(contracts.accuracy(fused, tl, tv)) == float(
            jax_contracts.accuracy(jfused, jl, jv))


def test_to_logprobs_matches_jax():
    logits, _, _ = _logits(2)
    got = contracts.to_logprobs([torch.from_numpy(l) for l in logits])
    want = jax_contracts.to_logprobs([jnp.asarray(l) for l in logits])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_ema_update_offset_and_masked_mean_match_jax():
    logits, _, valid = _logits(3)
    rng = np.random.default_rng(3)
    ema_x = rng.normal(size=(2, 7)).astype(np.float32)
    means = torch.stack([ema.masked_batch_mean(torch.from_numpy(l),
                                               torch.from_numpy(valid))
                         for l in logits])
    jmeans = jnp.stack([jax_ema.masked_batch_mean(jnp.asarray(l),
                                                  jnp.asarray(valid))
                        for l in logits])
    np.testing.assert_allclose(means.numpy(), np.asarray(jmeans), rtol=RTOL,
                               atol=ATOL)
    new = ema.ema_update(torch.from_numpy(ema_x), means)
    jnew = jax_ema.ema_update(jnp.asarray(ema_x), jmeans)
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ema.ema_offset(new).numpy(),
                               np.asarray(jax_ema.ema_offset(jnew)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_scheduler,step_size", [(True, 30), (True, 2),
                                                     (False, 30), (True, 0)])
def test_lr_schedule_matches_jax(use_scheduler, step_size):
    args = (0.01, use_scheduler, 7, step_size, 0.5, 60)
    torch_schedule = state.make_lr_schedule(*args)
    jax_schedule = jax_state.make_lr_schedule(*args)
    for step in [0, 1, 13, 14, 15, 209, 210, 211, 419, 420, 500]:
        np.testing.assert_allclose(torch_schedule(step),
                                   float(jax_schedule(step)), rtol=1e-6)


def test_sgd_matches_the_jax_optimizer_chain():
    """Weight decay added before the momentum buffer, whose first value is
    that gradient; the same three updates from the same gradients."""
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=(5,)).astype(np.float32)
    grads = [rng.normal(size=(5,)).astype(np.float32) for _ in range(3)]
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = state.make_optimizer([param], lr=0.1)
    tx = jax_state.make_optimizer(optax.constant_schedule(0.1))
    jp = jnp.asarray(p0)
    opt_state = tx.init(jp)
    for g in grads:
        param.grad = torch.from_numpy(g.copy())
        opt.step()
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-7)


ADAM_UPDATE_TOL = 2e-5


def test_make_optimizer_names_what_is_not_ported():
    """Adam against the JAX package's optax chain (scale_by_adam, eps
    outside the square root, then the learning rate) over ten steps under
    a StepLR schedule that halves it every two epochs of two steps; the
    port sets each step's rate as its train step does.  ``momentum`` and
    ``weight_decay`` are ignored under Adam on both sides.

    The moments are the same fp32 recurrences.  The bias corrections are
    not: optax computes ``1 - 0.999 ** t`` in fp32 (1.3e-5 off at t = 1),
    torch in float64, so each update parts by up to ~7e-6 of its size;
    the cumulative update is held to ADAM_UPDATE_TOL of its largest
    entry."""
    rng = np.random.default_rng(5)
    p0 = rng.normal(size=(6,)).astype(np.float32)
    grads = [rng.normal(scale=0.3, size=(6,)).astype(np.float32)
             for _ in range(10)]
    sched = (0.05, True, 2, 2, 0.5, 10)
    schedule = state.make_lr_schedule(*sched)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = state.make_optimizer([param], schedule(0), momentum=0.9,
                               weight_decay=1e-4, optimizer="adam")
    assert isinstance(opt, torch.optim.Adam)
    assert opt.defaults["betas"] == (0.9, 0.999)
    assert (opt.defaults["eps"], opt.defaults["weight_decay"]) == (1e-8, 0)
    tx = jax_state.make_optimizer(jax_state.make_lr_schedule(*sched),
                                  momentum=0.9, weight_decay=1e-4,
                                  optimizer="adam")
    jp = jnp.asarray(p0)
    opt_state = tx.init(jp)
    for step, g in enumerate(grads):
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        param.grad = torch.from_numpy(g.copy())
        opt.step()
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        got, want = param.detach().numpy() - p0, np.asarray(jp) - p0
        assert np.abs(got - want).max() <= ADAM_UPDATE_TOL * np.abs(
            want).max(), (step, got, want)
    adam = opt.state[param]
    np.testing.assert_allclose(adam["exp_avg"].numpy(),
                               np.asarray(opt_state[0].mu), rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(adam["exp_avg_sq"].numpy(),
                               np.asarray(opt_state[0].nu), rtol=1e-6,
                               atol=1e-10)


def test_make_optimizer_raises_for_an_unknown_name():
    with pytest.raises(ValueError, match="unknown optimizer"):
        state.make_optimizer([torch.nn.Parameter(torch.zeros(1))], 0.1,
                             optimizer="adamw")


def test_create_train_state_names_what_is_not_ported():
    """``lr_override`` (ported with FakeNews, ROADMAP.md queue A, item 16)
    pins the base rate whatever ``learning_rate`` says, as the JAX
    package's does."""
    spec = ModelSpec(module=TorchDense(2, 2))
    args = SimpleNamespace(learning_rate=0.1, num_classes=2)
    st = state.create_train_state(spec, args, 0, 1, device="cpu",
                                  optimizer="adam", lr_override=1e-4)
    assert st.lr_schedule(0) == st.lr_schedule(500) == 1e-4
    assert [g["lr"] for g in st.optimizer.param_groups] == [1e-4]


def test_create_train_state_builds_adam_and_its_lr_stream():
    spec = ModelSpec(module=TorchDense(2, 2))
    args = SimpleNamespace(learning_rate=0.1, num_classes=2)
    st = state.create_train_state(spec, args, 0, 1, device="cpu",
                                  optimizer="adam")
    assert isinstance(st.optimizer, torch.optim.Adam)
    assert st.lr_metric_name == "lr-Adam"
    st = state.create_train_state(spec, args, 0, 1, device="cpu")
    assert st.lr_metric_name == "lr-SGD"


def test_resolve_dtype_maps_the_config_key():
    assert resolve_dtype(SimpleNamespace()) is None
    assert resolve_dtype(SimpleNamespace(compute_dtype="float32")) is None
    assert resolve_dtype(
        SimpleNamespace(compute_dtype="bfloat16")) is torch.bfloat16
    with pytest.raises(ValueError):
        resolve_dtype(SimpleNamespace(compute_dtype="nosuch"))


@pytest.mark.parametrize("contract", ["jlogits", "jprobas", "ensemble",
                                      "ogm_ge", "qmf"])
def test_every_contract_builds_its_spec(contract):
    spec = ModelSpec(module=torch.nn.Identity(), contract=contract,
                     n_train_samples=8)
    assert spec.contract == contract


def test_unknown_contract_is_a_value_error():
    with pytest.raises(ValueError):
        ModelSpec(module=torch.nn.Identity(), contract="nosuch")


def test_step_generator_depends_on_seed_and_step():
    """The JAX step folds the step into the run seed's key: another seed
    or another step draws other masks, the same pair the same ones."""
    draw = lambda seed, step: torch.rand(4, generator=state.step_generator(
        seed, step))
    assert torch.equal(draw(5, 3), draw(5, 3))
    assert not torch.equal(draw(5, 3), draw(6, 3))
    assert not torch.equal(draw(5, 3), draw(5, 4))
    assert not torch.equal(draw(0, 1), draw(1, 0))
