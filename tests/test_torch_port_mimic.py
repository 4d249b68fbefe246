"""MIMIC in the port (``benchmarks/mimic.py``, ``MimicFusionNet``: MimicMLP
and GRUNet) against the JAX package on the CPU.

Every model type trains two steps (a full batch, then a padded tail) and
evaluates once on both sides from the JAX init's weights, at the published
geometry (5 static features, 24 x 12 series), in fp32, through
``tests/torch_port_benchmark_harness.py`` and the checks of
``tests/torch_port_contract_harness.py``: jprobas under Adam, the others
under SGD with momentum, ogm_ge with its modulation a no-op (no 4-D
parameter: no noise drawn on either side), qmf with its History.
``get_data`` equals the JAX package's bit for bit on the twin and on an
``im.pk`` of ``benchmarks/array_fixture.py``, under ``task_num`` -1 and 1
and two seeds.  The qmf CLI, in process on the twin, writes the JAX
CLI's ``metrics.jsonl`` keys; ``--resume`` restores the saved History and
trains one more epoch, and a run preempted mid-epoch and resumed ends
bit-equal to an uninterrupted one.
"""

import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.algos import ogm_ge as jax_ogm
from multimodal_clinical_tpu.benchmarks import mimic as jax_mimic
from multimodal_clinical_tpu_torch.algos import ogm_ge
from multimodal_clinical_tpu_torch.benchmarks import mimic
from multimodal_clinical_tpu_torch.benchmarks.array_fixture import (
    build_mimic_pickle,
)
from multimodal_clinical_tpu_torch.models.zoo import MimicFusionNet
from torch_port_benchmark_harness import (
    _args, check_cli_keys, cli_pair, gather_equal,
    preempted_run_resumes_bit_equal, resume_one_more_epoch, run_pair,
    spec_equal_jax,
)
from torch_port_contract_harness import (
    check_eval, check_qmf_tables, check_state, check_train_metrics,
)


def test_model_types_are_jax_s():
    assert mimic.MODEL_TYPES == jax_mimic.MODEL_TYPES


@pytest.mark.parametrize("model_type", mimic.MODEL_TYPES)
def test_spec_equals_jax(model_type):
    spec_equal_jax("mimic", model_type)


@pytest.mark.parametrize("model_type", mimic.MODEL_TYPES)
def test_two_steps_and_eval_match_jax(model_type):
    run = run_pair("mimic", model_type)
    check_train_metrics(run)
    check_state(run)
    check_qmf_tables(run)
    check_eval(run)
    assert run["state"].lr_metric_name == (
        "lr-Adam" if model_type == "jprobas" else "lr-SGD")
    assert run["noise_calls"] == 0


def test_unknown_model_type_raises():
    with pytest.raises(NotImplementedError, match="mimic model_type"):
        mimic.get_model_spec(_args("mimic", "ensemble_probas"), n_train=4)


def test_ogm_ge_is_an_exact_no_op_on_the_mimic_net():
    """No 4-D parameter under ``x1_model`` or ``x2_model``: the walk is
    empty, the gradients stay as they are with any noise source, and the
    coefficients are the JAX package's."""
    net = MimicFusionNet(6)
    assert list(ogm_ge.modulated_parameters(net)) == []
    rng = np.random.default_rng(0)
    logits = [rng.normal(size=(8, 6)).astype(np.float32) for _ in range(2)]
    label = rng.integers(0, 6, 8)
    valid = np.array([1] * 6 + [0] * 2, np.float32)
    for p in net.parameters():
        p.grad = torch.randn(p.shape)
    before = [p.grad.clone() for p in net.parameters()]

    def noise(name, g):
        raise AssertionError(f"noise drawn for {name}")

    ogm_ge.modulate_gradients(net, *map(torch.from_numpy, logits),
                              torch.from_numpy(label), noise, alpha=0.1,
                              valid=torch.from_numpy(valid))
    assert all(torch.equal(p.grad, b) for p, b in zip(net.parameters(),
                                                      before))
    got = ogm_ge.ogm_coefficients(*map(torch.from_numpy, logits),
                                  torch.from_numpy(label), 0.1,
                                  torch.from_numpy(valid))
    want = jax_ogm.ogm_coefficients(*logits, label, 0.1, valid)
    np.testing.assert_allclose([float(c) for c in got],
                               [float(c) for c in want], rtol=1e-6)


def test_get_data_equals_jax_on_the_twin(tmp_path):
    args = _args("mimic", "jlogits", data_path=str(tmp_path), seed=2)
    got, want = mimic.get_data(args), jax_mimic.get_data(args)
    gather_equal(got, want)
    assert got.synthetic and got.train_sampler == "sequential"


@pytest.mark.parametrize("seed", [0, 10])
@pytest.mark.parametrize("task", [-1, 1])
def test_get_data_equals_jax_on_files(tmp_path, task, seed):
    """``im.pk`` with inf and nan entries: zeroed, z-scored, the 6-way
    mortality label (task -1) or ``y_icd9[:, 1]``, split by the same
    ``random.Random(seed).shuffle``."""
    path = tmp_path / "im.pk"
    build_mimic_pickle(str(path), 50, seed=3)
    args = _args("mimic", "jlogits", data_path=str(path), task_num=task,
                 seed=seed)
    got, want = mimic.get_data(args), jax_mimic.get_data(args)
    gather_equal(got, want)
    assert not got.synthetic
    assert (len(got.train), len(got.val), len(got.test)) == (40, 5, 5)
    x = got.train.gather(np.arange(40))
    assert np.isfinite(x["x1"]).all() and np.isfinite(x["x2"]).all()
    labels = np.concatenate([got.train.labels, got.val.labels,
                             got.test.labels])
    assert set(labels) <= (set(range(6)) if task < 0 else {0, 1})
    if task < 0:
        assert len(set(labels)) > 2


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mimic_cli")
    return root, cli_pair("mimic", "qmf", root)


def test_cli_metrics_keys_equal_jax(cli_runs):
    _, runs = cli_runs
    rows = check_cli_keys(runs)
    assert "test_epoch/test_avg_df_acc" in runs["port"][0]
    assert any("train_step/train_df_acc" in r for r in rows)


def test_cli_resumes_one_more_epoch_with_the_history(cli_runs):
    root, _ = cli_runs
    saved, seen = resume_one_more_epoch("mimic", "qmf", root / "port")
    assert saved["qmf_correctness"].any()
    assert torch.equal(seen["qmf"][0], saved["qmf_correctness"])
    assert torch.equal(seen["qmf"][1], saved["qmf_confidence"])


def test_preempted_qmf_run_resumes_bit_equal(tmp_path):
    state = preempted_run_resumes_bit_equal("mimic", "qmf", tmp_path)
    assert state.qmf_correctness.any() and state.step == 8
