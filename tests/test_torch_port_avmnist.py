"""AV-MNIST in the port (``benchmarks/avmnist.py``, ``AVMnistFusionNet``)
against the JAX package on the CPU.

Every model type trains two steps (a full batch, then a padded tail) and
evaluates once on both sides from the JAX init's weights, at the published
geometry (28 x 28 images, 112 x 112 spectrograms), in fp32, through
``tests/torch_port_benchmark_harness.py`` and the checks of
``tests/torch_port_contract_harness.py`` (losses to 1e-5, accuracies and
counts equal, updates and BN buffers to 3e-4 of each tensor's largest
entry).  Plain SGD keeps no optimizer state on either side.  numpy seed
1's batches cross no ReLU or max-pool threshold within the two sides'
rounding, which these tolerances would show (seed 0's do).  ``get_data`` equals the
JAX package's bit for bit on the twin and on the six ``.npy`` files of
``benchmarks/array_fixture.py``.  The CLI, in process on the twin, writes
the JAX CLI's ``metrics.jsonl`` keys, and ``--resume`` restores the saved
state and trains one more epoch.
"""

import numpy as np
import pytest

from multimodal_clinical_tpu.benchmarks import avmnist as jax_avmnist
from multimodal_clinical_tpu_torch.benchmarks import avmnist
from multimodal_clinical_tpu_torch.benchmarks.array_fixture import (
    build_avmnist_tree,
)
from torch_port_benchmark_harness import (
    _args, check_cli_keys, cli_pair, gather_equal, resume_one_more_epoch,
    run_pair, spec_equal_jax,
)
from torch_port_contract_harness import (
    check_eval, check_qmf_tables, check_state, check_train_metrics,
)


def test_model_types_are_jax_s():
    assert avmnist.MODEL_TYPES == jax_avmnist.MODEL_TYPES


@pytest.mark.parametrize("model_type", avmnist.MODEL_TYPES)
def test_spec_equals_jax(model_type):
    spec_equal_jax("avmnist", model_type)


@pytest.mark.parametrize("model_type", avmnist.MODEL_TYPES)
def test_two_steps_and_eval_match_jax(model_type):
    run = run_pair("avmnist", model_type)
    check_train_metrics(run)
    check_state(run)
    check_qmf_tables(run)
    check_eval(run)
    assert run["opt"] == {"momentum": 0.0, "weight_decay": 0.0}


def test_unknown_model_type_raises():
    with pytest.raises(NotImplementedError, match="avmnist model_type"):
        avmnist.get_model_spec(_args("avmnist", "qmf"), n_train=4)


def test_get_data_equals_jax_on_the_twin(tmp_path):
    args = _args("avmnist", "jlogits", data_path=str(tmp_path / "none"),
                 seed=3)
    got, want = avmnist.get_data(args), jax_avmnist.get_data(args)
    gather_equal(got, want)
    assert got.synthetic and got.train_sampler == "sequential"
    assert got.train.gather(np.arange(2))["x2"].shape == (2, 112, 112, 1)


def test_get_data_equals_jax_on_files(tmp_path):
    """The six ``.npy`` files: /255, the first 55 000 train rows train, the
    rest val (none here: the row counts are cut), the test files test."""
    build_avmnist_tree(str(tmp_path), n_train=24, n_test=8, seed=1)
    args = _args("avmnist", "jlogits", data_path=str(tmp_path) + "/")
    got, want = avmnist.get_data(args), jax_avmnist.get_data(args)
    gather_equal(got, want)
    assert not got.synthetic
    assert (len(got.train), len(got.val), len(got.test)) == (24, 0, 8)
    x = got.train.gather(np.arange(24))
    assert x["x1"].dtype == np.float32 and 0 <= x["x1"].min()
    assert x["x1"].max() <= 1 and x["x2"].shape == (24, 112, 112, 1)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("avmnist_cli")
    return root, cli_pair("avmnist", "jprobas_jlogits", root)


def test_cli_metrics_keys_equal_jax(cli_runs):
    _, runs = cli_runs
    rows = check_cli_keys(runs)
    summary = runs["port"][0]
    assert "avg_test_acc" in summary and "x2_test_acc" in summary
    assert any("lr-SGD" in r for r in rows)


def test_cli_resumes_one_more_epoch(cli_runs):
    root, _ = cli_runs
    saved, _ = resume_one_more_epoch("avmnist", "jprobas_jlogits",
                                     root / "port")
    assert saved["step"] == 8  # 128 twin rows at batch 32, two epochs
