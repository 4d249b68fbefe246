"""The port's batch inference (``multimodal_clinical_tpu_torch/tools/
predict.py``) against the JAX package's ``tools/predict.py``, mirroring
``tests/test_predict.py``.

The JAX trainer trains AV-MNIST for an epoch and checkpoints; its best and
last weights are carried into port checkpoints through
``models/jax_weights.py``; both tools then predict the same split.  Rows
must agree: the same idx, label, fused and per-modality predictions (the
two LeNets' logits agree to ~1e-6, far from any argmax tie here), and the
fused log-probability within 1e-5 absolute (fp32 sums in another order).
The train split, the ``last`` checkpoint and MIMIC's ensemble fusion are
held as the JAX tests hold them, on the port alone.
"""

import csv
import os
import sys

import jax
import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.benchmarks import avmnist as jax_avmnist
from multimodal_clinical_tpu.engine.checkpoint import (
    BestCheckpointer as JaxCheckpointer,
)
from multimodal_clinical_tpu_torch import __main__ as cli
from multimodal_clinical_tpu_torch.benchmarks import avmnist, enrico, mimic
from multimodal_clinical_tpu_torch.data.synthetic import (
    make_synthetic_dataset,
)
from multimodal_clinical_tpu_torch.engine.checkpoint import BestCheckpointer
from multimodal_clinical_tpu_torch.engine.run import DataBundle, build_loaders
from multimodal_clinical_tpu_torch.engine.state import create_train_state
from multimodal_clinical_tpu_torch.engine.steps import make_eval_step
from multimodal_clinical_tpu_torch.models.jax_weights import (
    load_jax_variables,
)
from multimodal_clinical_tpu_torch.tools import predict
from test_engine_extras import build_trainer, make_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

torch.set_num_threads(2)

LOGPROB_ATOL = 1e-5


def _port_state(benchmark, args, data):
    spec, opt_kwargs = benchmark.get_model_spec(args, n_train=len(data.train))
    return create_train_state(spec, args, 0, 1, device="cpu",
                              **(opt_kwargs or {}))


def _carry_jax_checkpoint(args, jstate, jax_ckpt, port_ckpt, which):
    """A port checkpoint ('best' or 'last') holding the weights of the JAX
    run's checkpoint of the same name (``jstate`` its state's template)."""
    jck = JaxCheckpointer(jax_ckpt)
    jstate = (jck.restore_last(jstate) if which == "last"
              else jck.restore_best(jstate))
    state = _port_state(avmnist, args, avmnist.get_data(args))
    load_jax_variables(state.model, jax.device_get(jstate.params),
                       jax.device_get(jstate.batch_stats))
    ck = BestCheckpointer(port_ckpt)
    if which == "last":
        ck.save_last(state)
    else:
        ck.maybe_save(state, 1.0)


@pytest.mark.parametrize("model_type", ["jlogits", "jprobas"])
def test_predict_rows_match_jax(tmp_path, model_type):
    import predict as jax_predict

    args = make_args(num_epochs=1, batch_size=16, model_type=model_type,
                     ckpt_dir=str(tmp_path / "jax"))
    trainer, data = build_trainer(jax_avmnist, args)
    trainer.fit()
    test_acc = trainer.test()["test_epoch/test_avg_acc"]
    want, jsummary = jax_predict.predict(
        args, jax_avmnist, split="test", ckpt_dir=trainer.ckpt.ckpt_dir,
        which="best")
    port_ckpt = str(tmp_path / "port")
    _carry_jax_checkpoint(args, trainer.state, trainer.ckpt.ckpt_dir,
                          port_ckpt, "best")
    got, summary = predict.predict(args, avmnist, "test", port_ckpt, "best",
                                   device="cpu")
    assert summary["n"] == jsummary["n"] == len(data.test)
    assert abs(summary["acc"] - test_acc) < 1e-6
    assert [r[:-1] for r in got] == [r[:-1] for r in want]
    np.testing.assert_allclose([r[-1] for r in got], [r[-1] for r in want],
                               rtol=0, atol=LOGPROB_ATOL)


def test_predict_cli_matches_its_trainer(tmp_path):
    """The port's CLI trains AV-MNIST for two epochs on the CPU; the tool's
    CSV from its last checkpoint reproduces the trainer's test accuracy
    (AV-MNIST tests the final weights, as its legacy runner does), one row
    a test sample."""
    root = str(tmp_path)
    summary = cli.run_training(
        ["--dir", "avmnist", "--set", "num_epochs=2", "--set",
         f"ckpt_dir={root}", "--set", f"data_path={root}/none",
         "--set", "batch_size=16"], device="cpu")
    ckpt = [os.path.join(d, "ckpt") for d, _, files in os.walk(root)
            if "metrics.jsonl" in files][0]
    out = os.path.join(root, "rows.csv")
    got = predict.main(["--dir", "avmnist", "--ckpt", ckpt, "--out", out,
                        "--which", "last", "--device", "cpu",
                        "--set", f"data_path={root}/none",
                        "--set", "batch_size=16"])
    assert abs(got["acc"] - summary["test_epoch/test_avg_acc"]) < 1e-6
    with open(out, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["idx", "label", "pred", "pred_x1", "pred_x2",
                       "fused_logprob"]
    assert sorted(int(r[0]) for r in rows[1:]) == list(range(got["n"]))
    assert all(float(r[-1]) <= 0 for r in rows[1:])


def test_predict_needs_cuda_unless_given_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = make_args()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predict.predict(args, avmnist, "test", str(tmp_path), "best")


def test_predict_refuses_a_missing_checkpoint(tmp_path):
    args = make_args()
    for which in ("best", "last"):
        with pytest.raises(FileNotFoundError):
            predict.predict(args, avmnist, "test", str(tmp_path), which,
                            device="cpu")


def _small_enrico_bundle():
    small = [make_synthetic_dataset("enrico", 32, 4, seed=i, dirs_seed=0,
                                    shapes=[(32, 16, 3), (32, 16, 3)])
             for i in range(3)]
    return DataBundle(*small, train_sampler="weighted", synthetic=True)


def test_predict_train_split_one_row_per_sample(tmp_path, monkeypatch):
    """Enrico's train loader samples with replacement and gathers in train
    mode; ``--split train`` bypasses both: one row a train sample."""
    args = make_args(model_type="jlogits", batch_size=16,
                     ckpt_dir=str(tmp_path))
    bundle = _small_enrico_bundle()
    monkeypatch.setattr(enrico, "get_data", lambda _: bundle)
    BestCheckpointer(str(tmp_path)).maybe_save(
        _port_state(enrico, args, bundle), 0.5)
    rows, summary = predict.predict(args, enrico, "train", str(tmp_path),
                                    "best", device="cpu")
    assert summary["n"] == len(bundle.train)
    assert sorted(r[0] for r in rows) == list(range(len(bundle.train)))


def test_predict_last_checkpoint(tmp_path):
    """``--which last`` restores the newest rolling checkpoint: its rows
    are those of the state saved there, not of another."""
    args = make_args(batch_size=16)
    data = avmnist.get_data(args)
    state = _port_state(avmnist, args, data)
    ck = BestCheckpointer(str(tmp_path))
    ck.maybe_save(state, 0.5)
    with torch.no_grad():
        for p in state.model.parameters():
            p.mul_(1.5)
    state.step = 3
    ck.save_last(state)
    rows, summary = predict.predict(args, avmnist, "val", str(tmp_path),
                                    "last", device="cpu")
    assert summary["n"] == len(data.val)
    loader = build_loaders(args, data, "cpu")[1]
    out = make_eval_step(_port_spec(args, data))
    preds = {}
    for batch in loader:
        o = out(state, batch)
        for i, p, v in zip(batch["idx"].tolist(),
                           o["logits_stack"].mean(1).argmax(-1).tolist(),
                           o["valid"].tolist()):
            if v > 0:
                preds[i] = p
    assert {r[0]: r[2] for r in rows} == preds


def _port_spec(args, data):
    return avmnist.get_model_spec(args, n_train=len(data.train))[0]


def test_predict_ensemble_fusion_is_eval_mean(tmp_path):
    """MIMIC's w1/w2 weighting is train-only: the test step fuses the plain
    mean (x1+x2)/2 (mimic/ensemble_model.py:234-239), so the CSV's
    fused_logprob column uses exactly that fusion even where
    ``spec.fusion_weights=(0.8, 1.5)`` is set for the train loss."""
    args = make_args(model_type="ensemble", num_classes=6, batch_size=16,
                     ckpt_dir=str(tmp_path))
    data = mimic.get_data(args)
    state = _port_state(mimic, args, data)
    spec = mimic.get_model_spec(args, len(data.train))[0]
    assert spec.fusion_weights == (0.8, 1.5)
    BestCheckpointer(str(tmp_path)).maybe_save(state, 0.5)
    rows, _ = predict.predict(args, mimic, "test", str(tmp_path), "best",
                              device="cpu")
    got = {r[0]: r[-1] for r in rows}
    eval_step = make_eval_step(spec)
    for batch in build_loaders(args, data, "cpu")[2]:
        out = eval_step(state, batch)
        stack = out["logits_stack"].numpy().astype(np.float32)
        fused = (stack[:, 0] + stack[:, 1]) / 2
        shifted = fused - fused.max(-1, keepdims=True)
        logp = shifted - np.log(np.exp(shifted).sum(-1, keepdims=True))
        for b, i in enumerate(batch["idx"].tolist()):
            if out["valid"][b] > 0:
                np.testing.assert_allclose(got[i], logp[b].max(), rtol=1e-5,
                                           atol=1e-5)
