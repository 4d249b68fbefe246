"""Shared harness of ``test_torch_port_multiseed*.py``: the port's
multi-seed sweep step against its single-seed step, on the CPU, in fp32.

``run_both`` trains S seeds for a few steps on per-seed data, once as S
single-seed runs (each drawn by ``create_train_state`` with its seed, on
a fresh net from ``make_spec``) and once as the sweep, then evaluates
once on per-seed and on shared data.  Both sides draw their dropout
masks, OGM-GE noise and SpecAugment bands from their per-seed, per-step
generators, so nothing is injected.  They differ in rounding only: the
sweep's convolutions and matmuls run grouped over the seeds.

``check_seeds`` holds seed s of the sweep against run s to the
tolerances of ``test_torch_port_step.py`` and ``test_torch_port_loop.py``:
losses to 1e-5 relative, BN buffers to 1e-4 relative and 1e-5 absolute,
parameter updates (beside 8 ulps of the parameter, the rounding of
reading an update as after - before) and optimizer state to 3e-4 of each
tensor's largest entry, eval logits to 1e-5 relative and absolute (the
contract harness's ``check_eval``).  Under Adam, which moves an entry by
a share of the learning rate whatever its gradient's size, updates are
held where both sides' gradient entries agree to ADAM_GRAD_RTOL at every
step, at least ADAM_HELD_SHARE of each tensor, and the moments everywhere
(the policy of ``torch_port_contract_harness.check_state``, with its
``rounding_grads`` and ``float64_only`` keys).  A case's data must cross
no ReLU or max-pool threshold within fp32 rounding in its steps: a
crossing shows as an accuracy or a loss apart beyond those limits.

``vmap_fallback_is_an_error``, imported into a test module, makes vmap's
per-sample fallback warning an error there.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from multimodal_clinical_tpu_torch.engine.multiseed import (
    create_multiseed_state, make_multiseed_steps,
)
from multimodal_clinical_tpu_torch.engine.state import create_train_state
from multimodal_clinical_tpu_torch.engine.steps import (
    make_eval_step, make_train_step,
)

SEEDS = (0, 1, 2)
LOSS_RTOL = 1e-5
BUFFER_RTOL, BUFFER_ATOL = 1e-4, 1e-5
EMA_ATOL = 1e-5
SCALED_TOL = 3e-4
# an update read as (after - before) in fp32 carries the rounding of the
# parameter itself: 8 ulps of its largest entry
PARAM_ULPS = 8 * 2.0 ** -23
TABLE_RTOL, TABLE_ATOL = 1e-5, 1e-6
# metrics held to LOSS_RTOL: every loss (train_loss, loss,
# train_vicreg_loss, ...); the others (counts, accuracies) exactly
CONTINUOUS_SUFFIX = "loss"
# eval logits: those of the harness's check_eval
LOGITS_RTOL, LOGITS_ATOL = 1e-5, 1e-5
# those of torch_port_contract_harness
ADAM_GRAD_RTOL, ADAM_HELD_SHARE = 1e-3, 0.9
ROUNDING_GRAD = 1e-6


@pytest.fixture(autouse=True)
def vmap_fallback_is_an_error():
    """vmap runs an op without a batching rule once per seed, and warns
    so only when asked: here it is asked, and the warning is an error."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error",
                                    message="There is a performance drop")
            yield
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def stacked(batches):
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def run_both(make_spec, data, seeds=SEEDS):
    """(single-seed runs, the sweep, the sweep's spec).  ``make_spec()``
    gives a fresh (spec, optimizer kwargs, args); ``data[s]`` is seed s's
    list of per-step torch batches, whose last is also seed s's eval
    batch, and seed 0's the shared one.  Each side is a dict of per-step
    metrics, eval outputs on per-seed (``own``) and on shared data, and
    the final state."""
    shared_eval = data[0][-1]
    singles = []
    for s, seed in enumerate(seeds):
        # a fresh net each run, as the CLI builds one
        spec, opt_kwargs, args = make_spec()
        state = create_train_state(spec, args, seed, steps_per_epoch=100,
                                   device="cpu", **opt_kwargs)
        init = {k: v.detach().clone()
                for k, v in state.model.named_parameters()}
        train, evaluate = make_train_step(spec), make_eval_step(spec)
        metrics, grads = [], []
        for batch in data[s]:
            state, m = train(state, batch)
            metrics.append({k: v.clone() for k, v in m.items()})
            grads.append(_grads(state.model.named_parameters()))
        singles.append(dict(state=state, init=init, metrics=metrics,
                            grads=grads,
                            own=evaluate(state, data[s][-1]),
                            shared=evaluate(state, shared_eval)))
    spec, opt_kwargs, args = make_spec()
    sweep = create_multiseed_state(spec, args, seeds, steps_per_epoch=100,
                                   device="cpu", opt_kwargs=opt_kwargs)
    train, own_eval = make_multiseed_steps(spec, per_seed_eval_data=True)
    _, shared_eval_step = make_multiseed_steps(spec)
    metrics, grads = [], []
    for step in range(len(data[0])):
        sweep, m = train(sweep, stacked([d[step] for d in data]))
        metrics.append({k: v.clone() for k, v in m.items()})
        grads.append(_grads(sweep.params.items()))
    swept = dict(state=sweep, metrics=metrics, grads=grads,
                 own=own_eval(sweep, stacked([d[-1] for d in data])),
                 shared=shared_eval_step(sweep, shared_eval))
    return singles, swept, spec


def _grads(named):
    return {k: p.grad.detach().clone() for k, p in named
            if p.grad is not None}


def _scaled_close(got, want, what, atol=0.0):
    got, want = got.double(), want.double()
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= SCALED_TOL * float(want.abs().max()) + atol, (what, err)


def check_values(got: dict, want: dict, what: str):
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for k in want:
        if k == "logits_stack":
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=LOGITS_RTOL, atol=LOGITS_ATOL,
                                       err_msg=f"{what} {k}")
        elif k.endswith(CONTINUOUS_SUFFIX):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=LOSS_RTOL, err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                          err_msg=f"{what} {k}")


def check_seeds(singles, swept, spec, history_rows=None, rounding_grads=(),
                float64_only=()):
    """Seed s of the sweep against run s: every step's metrics, both
    evals, parameter updates, optimizer state, buffers, EMA and (under
    qmf) the History, whose tables must hold ``history_rows`` written
    rows (the padded tail's repeated row writes nothing).  The parameters
    ending in one of ``rounding_grads`` have a gradient that is zero in
    exact arithmetic: both sides' are held below ROUNDING_GRAD, and each
    side's update within what the optimizer makes of such gradients.
    Those starting with one of ``float64_only`` have an fp32 gradient too
    ill-conditioned to compare: only their optimizer state's keys are."""
    sweep = swept["state"]
    steps = len(swept["metrics"])
    for s, single in enumerate(singles):
        state = single["state"]
        for step, (m, sm) in enumerate(zip(swept["metrics"],
                                           single["metrics"])):
            check_values({k: v[s] for k, v in m.items()}, sm,
                         f"seed {s} step {step}")
        for key in ("own", "shared"):
            check_values({k: v[s] for k, v in swept[key].items()},
                         single[key], f"seed {s} eval {key}")
        assert sweep.step == state.step == len(swept["metrics"])
        named = dict(state.model.named_parameters())
        for name, p in named.items():
            stacked_p = sweep.params[name]
            got = stacked_p[s].detach() - single["init"][name]
            want = p.detach() - single["init"][name]
            kept = state.optimizer.state[p]
            swept_kept = sweep.optimizer.state[stacked_p]
            assert set(kept) == set(swept_kept), name
            if name.startswith(tuple(float64_only)):
                continue
            lr = state.optimizer.param_groups[0]["lr"]
            adam = "exp_avg" in kept
            if name.endswith(tuple(rounding_grads)):
                for side in (swept["grads"], single["grads"]):
                    assert all(
                        float((g[name][s] if side is swept["grads"]
                               else g[name]).abs().max()) <= ROUNDING_GRAD
                        for g in side), name
                # Adam moves such an entry by up to twice the rate a
                # step; SGD's momentum sums ``steps`` rounding gradients
                bound = (2 * lr * steps if adam
                         else ROUNDING_GRAD * steps * lr * steps)
                assert max(float(got.abs().max()),
                           float(want.abs().max())) <= bound, name
                continue
            held = slice(None)
            if adam and name in single["grads"][0]:
                held = torch.stack([
                    (sw[name][s] - si[name]).abs()
                    <= ADAM_GRAD_RTOL * si[name].abs()
                    for sw, si in zip(swept["grads"], single["grads"])
                ]).all(0)
                share = float(held.float().mean())
                assert share >= ADAM_HELD_SHARE, (name, share)
            _scaled_close(got[held], want[held], f"seed {s} update {name}",
                          atol=PARAM_ULPS * float(p.detach().abs().max()))
            for k, v in kept.items():
                if torch.is_tensor(v) and v.dim():
                    _scaled_close(swept_kept[k][s], v, f"seed {s} {k} {name}")
                else:
                    assert float(swept_kept[k]) == float(v), (name, k)
        for name, buf in state.model.named_buffers():
            np.testing.assert_allclose(
                sweep.buffers[name][s].numpy(), buf.numpy(),
                rtol=BUFFER_RTOL, atol=BUFFER_ATOL, err_msg=name)
        np.testing.assert_allclose(sweep.ema[s].numpy(), state.ema.numpy(),
                                   atol=EMA_ATOL)
        if spec.contract == "qmf":
            for got, want in ((sweep.qmf_correctness, state.qmf_correctness),
                              (sweep.qmf_confidence, state.qmf_confidence)):
                np.testing.assert_allclose(got[s].numpy(), want.numpy(),
                                           rtol=TABLE_RTOL, atol=TABLE_ATOL)
            assert int((state.qmf_correctness != 0).any(dim=0).sum()) == (
                history_rows), "History rows written"
