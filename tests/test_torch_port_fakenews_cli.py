"""The FakeNews CLI of the port against the JAX CLI, in process on the
CPU, on the narrowed twins of ``tests/torch_port_benchmark_harness.py``
(``narrow``): ``jlogits_dialogue`` (three towers) and ``jlogits_embed``
(one fused head) write the JAX CLI's ``metrics.jsonl`` keys; ``--resume``
restores the saved state and trains one more epoch; an embed run (its
fusion dropout drawn from the step's generator) preempted mid-epoch and
resumed ends bit-equal to an uninterrupted one."""

import pytest
import torch

from torch_port_benchmark_harness import (
    check_cli_keys, cli_pair, preempted_run_resumes_bit_equal,
    resume_one_more_epoch,
)

torch.set_num_threads(2)


def _bench(model_type):
    return "fakenews_embed" if "embed" in model_type else "fakenews"


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fakenews_cli")
    return root, {mt: cli_pair(_bench(mt), mt, root / mt)
                  for mt in ("jlogits_dialogue", "jlogits_embed")}


@pytest.mark.parametrize("model_type", ["jlogits_dialogue", "jlogits_embed"])
def test_cli_metrics_keys_equal_jax(cli_runs, model_type):
    _, runs = cli_runs
    rows = check_cli_keys(runs[model_type])
    # the legacy flat names (fakenews/model.py:210-213)
    assert "avg_test_acc" in runs[model_type]["port"][0]
    if model_type == "jlogits_embed":
        assert not any("x2_acc" in k for r in rows for k in r)


def test_cli_resumes_one_more_epoch(cli_runs):
    root, _ = cli_runs
    saved, _ = resume_one_more_epoch("fakenews", "jlogits_dialogue",
                                     root / "jlogits_dialogue" / "port")
    assert saved["ema"].shape == (3, 6)


def test_preempted_embed_run_resumes_bit_equal(tmp_path):
    """The embed net's fusion dropout draws from the step's generator, so
    a run preempted mid-epoch and resumed ends bit-equal."""
    state = preempted_run_resumes_bit_equal("fakenews_embed",
                                            "jlogits_embed", tmp_path,
                                            after=1)
    assert state.step == 4 and state.ema.shape == (1, 6)
