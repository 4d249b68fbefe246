"""The Food101 CLI of the port for the legacy pair against the JAX CLI, in
process on the CPU, both in fp32 with the towers narrowed through the
config's keys (``torch_port_benchmark_harness.LEGACY_TINY``), the port
started from the JAX init's weights and BERT's seven dropouts injected on
both sides, so the losses match row by row.

jprobas_jlogits on the twin (32 x 32 images and 16 ids; the config's batch
of 128, so one step an epoch) for two epochs: the same ``metrics.jsonl``
keys in the same order of rows, the same losses row by row to 1e-5
relative (two fp32 trainings of two steps, only the heads trained), then
``--resume`` with one more epoch restores the step, weights, BN running
statistics, momentum and EMA as saved.  jprobas on a
``build_food101_legacy_tree`` corpus (224 x 224 JPEGs, WordPiece titles,
batch 8) for one epoch, the same way.
"""

import math

import jax
import numpy as np
import pytest
import torch

import multimodal_clinical_tpu_torch.engine.run as port_run
from multimodal_clinical_tpu_torch.benchmarks import disk_fixture
from multimodal_clinical_tpu_torch.engine import steps as port_steps
from multimodal_clinical_tpu_torch.models.jax_weights import (
    load_jax_variables,
)
import torch_port_benchmark_harness as benchmark_harness
import torch_port_contract_harness as contract_harness
from torch_port_benchmark_harness import (
    LEGACY_TINY, check_cli_keys, cli_pair, patch_dropout,
    resume_one_more_epoch, row_kind,
)

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
N_DROPOUTS = 1 + 3 * LEGACY_TINY["legacy_bert_layers"]


def _pair_from_jax_init(root, model_type, *extra):
    """``cli_pair`` in fp32 with the port started from the JAX CLI's init
    weights and batch statistics and the dropout masks injected on both
    sides: (runs, the draws of each side)."""
    captured = {}
    with pytest.MonkeyPatch.context() as mp:
        # an init of its own: a JAX run donates its init's arrays
        mp.setattr(contract_harness, "_INIT", {})
        per_step, drawn = patch_dropout(mp, N_DROPOUTS, nchw=False)
        mp.setattr(port_steps, "device_dropout",
                   lambda seed, step: per_step(None))
        cached_init = benchmark_harness._cached_init

        def capturing_init(key, flax_init, options=None):
            """The JAX CLI's init, copied out as it gives it (the JAX
            step donates the arrays)."""
            init = cached_init(key, flax_init, options)

            def run(*args, **kwargs):
                variables = init(*args, **kwargs)
                captured.setdefault("variables", jax.tree_util.tree_map(
                    np.array, variables))
                return variables
            return run

        mp.setattr(benchmark_harness, "_cached_init", capturing_init)
        create = port_run.create_train_state

        def from_jax_init(*args, **kwargs):
            state = create(*args, **kwargs)
            v = captured["variables"]
            load_jax_variables(state.model, v["params"], v["batch_stats"])
            return state

        mp.setattr(port_run, "create_train_state", from_jax_init)
        runs = cli_pair("food101_legacy", model_type, root, "--set",
                        "compute_dtype=float32", *extra)
    return runs, drawn


def _losses_equal(runs):
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
    summary, jsummary = runs["port"][0], runs["jax"][0]
    assert math.isclose(summary["test_epoch/test_avg_loss"],
                        jsummary["test_epoch/test_avg_loss"],
                        rel_tol=LOSS_RTOL)
    return compared


@pytest.fixture(scope="module")
def twin_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("food101_legacy_cli")
    return (root,) + _pair_from_jax_init(root, "jprobas_jlogits")


def test_twin_cli_metrics_keys_and_losses_equal_jax(twin_run):
    _, runs, drawn = twin_run
    assert _losses_equal(runs) >= 6
    # BERT's draws of one step (128 rows of 16 ids), at each of the port's
    # two train steps
    width = LEGACY_TINY["legacy_bert_width"]
    assert drawn["jax"] == [((128, 16, width), 0.9)] + [
        ((1, 1, 16, 16), 0.9), ((128, 16, width), 0.9),
        ((128, 16, width), 0.9)] * LEGACY_TINY["legacy_bert_layers"]
    assert drawn["port"] == drawn["jax"] * 2


def test_twin_cli_resume_restores_the_state(twin_run):
    root, _, _ = twin_run
    saved, seen = resume_one_more_epoch("food101_legacy", "jprobas_jlogits",
                                        root / "port")
    stats = [k for k in saved["model"] if k.endswith("running_mean")]
    assert stats and all(torch.equal(seen["model"][k], saved["model"][k])
                         for k in stats)
    # momentum for the two heads' four leaves only: the towers are frozen
    assert len(saved["optimizer"]["state"]) == 4


def test_disk_cli_losses_equal_jax(tmp_path):
    tree = tmp_path / "tree"
    disk_fixture.build_food101_legacy_tree(str(tree), 12, 6, n_classes=5)
    runs, drawn = _pair_from_jax_init(
        tmp_path, "jprobas", "--set", f"data_path={tree}/", "--set",
        "batch_size=8", "--set", "num_epochs=1", "--set", "num_classes=5")
    assert _losses_equal(runs) >= 4
    assert drawn["port"] == drawn["jax"] * 2  # two train steps an epoch
    assert drawn["jax"][0] == ((8, 16, LEGACY_TINY["legacy_bert_width"]),
                               0.9)
