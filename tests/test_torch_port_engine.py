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


def test_make_optimizer_names_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        state.make_optimizer([torch.nn.Parameter(torch.zeros(1))], 0.1,
                             optimizer="adam")


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
