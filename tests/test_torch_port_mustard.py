"""MUsTARD in the port (``benchmarks/mustard.py``, ``MustardFusionNet``:
three LstmClassifiers) against the JAX package on the CPU.

Both model types train two steps (a full batch, then a padded tail) under
Adam and evaluate once on both sides from the JAX init's weights, at the
published geometry (40 x {371, 81, 300}, three inputs and three logits),
in fp32 as ``configs/mustard.yaml`` computes, through
``tests/torch_port_benchmark_harness.py`` and the checks of
``tests/torch_port_contract_harness.py``.  ``get_data`` equals the JAX
package's bit for bit on the twin and on a ``sarcasm.pkl`` of
``benchmarks/array_fixture.py`` (all-zero text rows dropped, sequences
shorter and longer than 40, non-finite entries zeroed).  The CLI, in
process on the twin, writes the JAX CLI's ``metrics.jsonl`` keys, the
``x3`` aliases and ``lr-Adam`` included; ``--resume`` restores the saved
Adam moments and trains one more epoch, and a run preempted mid-epoch and
resumed ends bit-equal to an uninterrupted one.
"""

import numpy as np
import pytest

from multimodal_clinical_tpu.benchmarks import mustard as jax_mustard
from multimodal_clinical_tpu_torch.benchmarks import mustard
from multimodal_clinical_tpu_torch.benchmarks.array_fixture import (
    build_mustard_pickle,
)
from torch_port_benchmark_harness import (
    _args, check_cli_keys, cli_pair, gather_equal,
    preempted_run_resumes_bit_equal, resume_one_more_epoch, run_pair,
    spec_equal_jax,
)
from torch_port_contract_harness import (
    check_eval, check_state, check_train_metrics,
)


def test_model_types_are_jax_s():
    assert mustard.MODEL_TYPES == jax_mustard.MODEL_TYPES


@pytest.mark.parametrize("model_type", mustard.MODEL_TYPES)
def test_spec_equals_jax(model_type):
    spec_equal_jax("mustard", model_type)


@pytest.mark.parametrize("model_type", mustard.MODEL_TYPES)
def test_two_steps_and_eval_match_jax(model_type):
    run = run_pair("mustard", model_type)
    check_train_metrics(run)
    check_state(run)
    check_eval(run)
    assert run["out"]["logits_stack"].shape == (6, 3, 2)
    assert "train_x3_acc" in run["metrics"][0]
    assert run["state"].lr_metric_name == "lr-Adam"


def test_unknown_model_type_raises():
    with pytest.raises(NotImplementedError, match="mustard model_type"):
        mustard.get_model_spec(_args("mustard", "jprobas"), n_train=4)


def test_get_data_equals_jax_on_the_twin(tmp_path):
    args = _args("mustard", "jlogits", data_path=str(tmp_path), seed=1)
    got, want = mustard.get_data(args), jax_mustard.get_data(args)
    gather_equal(got, want)
    assert (len(got.train), len(got.val), len(got.test)) == (64, 32, 32)


def test_get_data_equals_jax_on_files(tmp_path, capsys):
    path = tmp_path / "sarcasm.pkl"
    build_mustard_pickle(str(path), 12, 6, 6, seed=2)
    args = _args("mustard", "jlogits", data_path=str(path), max_seq_len=40)
    got = mustard.get_data(args)
    assert "mustard/ERROR.md" in capsys.readouterr().out
    want = jax_mustard.get_data(args)
    gather_equal(got, want)
    assert not got.synthetic
    # row 1 of each split has all-zero text and is dropped
    assert (len(got.train), len(got.val), len(got.test)) == (11, 5, 5)
    x = got.train.gather(np.arange(11))
    assert [x[f"x{i}"].shape for i in (1, 2, 3)] == [
        (11, 40, 371), (11, 40, 81), (11, 40, 300)]
    assert np.isfinite(x["x1"]).all()
    # sample 0 is 25 long: end-padded with zeros
    assert not x["x2"][0, 25:].any() and x["x2"][0, 24].any()


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mustard_cli")
    return root, cli_pair("mustard", "jlogits", root)


def test_cli_metrics_keys_equal_jax(cli_runs):
    _, runs = cli_runs
    rows = check_cli_keys(runs)
    summary = runs["port"][0]
    assert "x3_test_acc" in summary and "test_epoch/test_avg_x3_acc" in summary
    epochs = [r for r in rows if r.get("epoch") == 0]
    assert "x3_val_acc" in epochs[0] and "lr-Adam" in epochs[0]


def test_cli_resumes_one_more_epoch_with_the_adam_moments(cli_runs):
    root, _ = cli_runs
    saved, seen = resume_one_more_epoch("mustard", "jlogits", root / "port")
    moments = saved["optimizer"]["state"]
    assert moments and all("exp_avg_sq" in m for m in moments.values())


def test_preempted_run_resumes_bit_equal(tmp_path):
    state = preempted_run_resumes_bit_equal("mustard", "jlogits", tmp_path,
                                            after=1)
    assert state.step == 4
