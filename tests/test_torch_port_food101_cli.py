"""The Food101 CLI of the port against the JAX CLI, in process on the CPU,
on the twin narrowed by ``tests/torch_port_benchmark_harness.py``
(``narrow``: the SigLIP towers at ``SIGLIP_TINY``, 16 ids and 32 x 32
pixels; the config's batch of 128, so one step an epoch).

qmf (the config's default) runs two epochs on each side in fp32, the port
from the JAX init's weights with the heads' dropout masks injected on both
sides: the same ``metrics.jsonl`` keys in the same order of rows, and the
same losses row by row to 1e-5 relative (two fp32 trainings of two steps
that cross no threshold).  ``--resume`` restores the step, weights,
momentum, EMA and the QMF History as saved and trains a third epoch.  A
qmf run preempted mid-epoch (its heads' dropout drawn from the step's
generator) and resumed ends bit-equal to an uninterrupted one.
"""

import math

import jax
import numpy as np
import pytest
import torch

import multimodal_clinical_tpu_torch.engine.run as port_run
from multimodal_clinical_tpu_torch.engine import steps as port_steps
from multimodal_clinical_tpu_torch.models.jax_weights import (
    load_jax_variables,
)
import torch_port_benchmark_harness as benchmark_harness
from torch_port_benchmark_harness import (
    check_cli_keys, cli_pair, patch_dropout, preempted_run_resumes_bit_equal,
    resume_one_more_epoch, row_kind,
)

torch.set_num_threads(2)

LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("food101_cli")
    captured = {}
    with pytest.MonkeyPatch.context() as mp:
        per_step, drawn = patch_dropout(mp, 4)
        mp.setattr(port_steps, "device_dropout",
                   lambda seed, step: per_step(None))
        cached_init = benchmark_harness._cached_init

        def capturing_init(key, flax_init, options=None):
            """The JAX CLI's init, its parameters copied out as it gives
            them (the JAX step donates the arrays)."""
            init = cached_init(key, flax_init, options)

            def run(*args, **kwargs):
                variables = init(*args, **kwargs)
                captured.setdefault("params", jax.tree_util.tree_map(
                    np.array, variables["params"]))
                return variables
            return run

        mp.setattr(benchmark_harness, "_cached_init", capturing_init)
        create = port_run.create_train_state

        def from_jax_init(*args, **kwargs):
            state = create(*args, **kwargs)
            load_jax_variables(state.model, captured["params"], {})
            return state

        mp.setattr(port_run, "create_train_state", from_jax_init)
        runs = cli_pair("food101", "qmf", root, "--set",
                        "compute_dtype=float32")
    return root, runs, drawn


def test_cli_metrics_keys_and_losses_equal_jax(cli_run):
    _, runs, drawn = cli_run
    rows = check_cli_keys(runs)
    jrows = runs["jax"][1]
    assert len(rows) == len(jrows)
    compared = 0
    for row, jrow in zip(rows, jrows):
        assert row_kind(row) == row_kind(jrow)
        for key, value in jrow.items():
            if "loss" in key and isinstance(value, float):
                np.testing.assert_allclose(row[key], value, rtol=LOSS_RTOL,
                                           err_msg=key)
                compared += 1
    assert compared >= 6
    summary, jsummary = runs["port"][0], runs["jax"][0]
    assert math.isclose(summary["test_epoch/test_avg_loss"],
                        jsummary["test_epoch/test_avg_loss"], rel_tol=LOSS_RTOL)
    # the heads' four dropouts, at each of the port's two train steps
    assert drawn["port"] == drawn["jax"] * 2
    assert drawn["jax"] == [((128, 512), 0.8)] * 4


def test_cli_resume_restores_the_history_and_momentum(cli_run):
    root, _, _ = cli_run
    saved, seen = resume_one_more_epoch("food101", "qmf", root / "port")
    corr, conf = seen["qmf"]
    assert torch.equal(corr, saved["qmf_correctness"])
    assert torch.equal(conf, saved["qmf_confidence"])
    assert corr.shape == (2, 128) and corr.any()
    assert saved["optimizer"]["state"]  # SGD's momentum, restored equal


def test_preempted_qmf_run_resumes_bit_equal(tmp_path):
    state = preempted_run_resumes_bit_equal("food101", "qmf", tmp_path,
                                            after=0)
    assert state.step == 2 and state.qmf_correctness.shape == (2, 128)
