"""``python -m multimodal_clinical_tpu_torch --dir cremad --set
model_type=qmf`` against the JAX CLI on the CPU, in process, on the same
narrowed Crema-D twin (modality shapes and towers monkeypatched on both
sides: width 4, one block per stage; fp32), the port from the JAX run's
initial weights: the same ``metrics.jsonl`` keys per row kind, the same
per-epoch accuracies and losses, the same QMF History at the end.  Then a
preempted and resumed run of the port ends bit-equal to an uninterrupted
one, tables included.

The twin ships its spectrogram as ``x1`` and Crema-D draws nothing, so
the two runs see the same batches in the same order and no random draw.
The twin's seed-5 data at this width cross no ReLU or max-pool threshold
in the 8 steps of the two epochs on either side (see
``test_torch_port_step.py``), which the tolerances below, those of
``test_torch_port_loop.py``, would show.
"""

import functools
import json
import os
import signal
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import multimodal_clinical_tpu.__main__ as jax_main
import multimodal_clinical_tpu.data.synthetic as jax_syn
import multimodal_clinical_tpu.engine.run as jax_run
from multimodal_clinical_tpu.models import resnet as jax_resnet
from multimodal_clinical_tpu.models import zoo as jax_zoo

import multimodal_clinical_tpu_torch.__main__ as port_main
import multimodal_clinical_tpu_torch.data.synthetic as port_syn
import multimodal_clinical_tpu_torch.engine.run as port_run
from multimodal_clinical_tpu_torch.benchmarks import cremad
from multimodal_clinical_tpu_torch.config import load_config
from multimodal_clinical_tpu_torch.engine.state import create_train_state
from multimodal_clinical_tpu_torch.engine.trainer import Preempted, Trainer
from multimodal_clinical_tpu_torch.models import zoo as port_zoo
from multimodal_clinical_tpu_torch.models.jax_weights import (
    load_jax_variables,
)
from multimodal_clinical_tpu_torch.models.resnet import ResNetEncoder
from multimodal_clinical_tpu_torch.models.zoo import CremadFusionNet
from multimodal_clinical_tpu_torch.utils import native

torch.set_num_threads(2)

WIDTH, BATCH, STAGES = 4, 16, (1, 1, 1, 1)
SHAPES = [(17, 20, 1), (2, 16, 16, 3)]
RUN_NAME = "cremad_cls6"  # configs/cremad.yaml group
LOSS_RTOL = 1e-5
TABLE_RTOL, TABLE_ATOL = 1e-5, 1e-6


def _argv(root, *extra):
    return ["--dir", "cremad", "--set", "model_type=qmf",
            "--set", "num_epochs=2", "--set", f"batch_size={BATCH}",
            "--set", "log_every_n_steps=2", "--set", "compute_dtype=float32",
            "--set", f"ckpt_dir={root}", "--set", f"data_path={root}/none",
            *extra]


def _narrow(monkeypatch):
    monkeypatch.setitem(jax_syn.BENCHMARK_SHAPES, "cremad", SHAPES)
    monkeypatch.setitem(port_syn.BENCHMARK_SHAPES, "cremad", SHAPES)
    monkeypatch.setattr(jax_zoo, "ResNetEncoder",
                        functools.partial(jax_resnet.ResNetEncoder,
                                          width=WIDTH, stage_sizes=STAGES))
    monkeypatch.setattr(port_zoo, "ResNetEncoder",
                        functools.partial(ResNetEncoder, stage_sizes=STAGES))
    monkeypatch.setattr(cremad, "CremadFusionNet",
                        functools.partial(CremadFusionNet, width=WIDTH))


@pytest.fixture
def narrow(monkeypatch):
    _narrow(monkeypatch)


def _rows(run_dir):
    path = Path(run_dir) / RUN_NAME / "metrics.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def _row_kind(row):
    for prefix in ("train_step", "val_step", "test_step"):
        if any(k.startswith(prefix + "/") for k in row):
            return prefix
    return "test_epoch" if row.get("epoch") == -1 else "epoch"


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cremad_cli")
    seen = {}

    def jax_init(*args, **kwargs):
        state = init_state(*args, **kwargs)
        seen["params"] = jax.tree_util.tree_map(np.asarray, state.params)
        seen["stats"] = jax.tree_util.tree_map(np.asarray,
                                               state.batch_stats)
        return state

    def port_init(*args, **kwargs):
        state = create_state(*args, **kwargs)
        load_jax_variables(state.model, seen["params"], seen["stats"])
        return state

    def capture(cls, name):
        class Captured(cls):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                seen[name] = self
        return Captured

    def jit_init(module, rngs, *inputs, train=False):
        return jax.jit(lambda r, *xs: flax_init(module, r, *xs,
                                                train=train))(rngs, *inputs)

    init_state, create_state = (jax_run.init_state_on_mesh,
                                port_run.create_train_state)
    flax_init = jax_zoo.CremadFusionNet.init
    with pytest.MonkeyPatch.context() as mp:
        _narrow(mp)
        mp.setattr(jax_zoo.CremadFusionNet, "init", jit_init)
        mp.setattr(jax_run, "init_state_on_mesh", jax_init)
        mp.setattr(jax_run, "Trainer", capture(jax_run.Trainer, "jax"))
        mp.setattr(port_run, "create_train_state", port_init)
        mp.setattr(port_run, "Trainer", capture(port_run.Trainer, "port"))
        jax_summary = jax_main.run_training(_argv(root / "jax"))
        # the weighted samplers draw from the alias table where the native
        # library loads: let the port look again after the JAX binding's
        # make, so both sides draw the same stream
        mp.setattr(native, "_lib", None)
        mp.setattr(native, "_tried", False)
        summary = port_main.run_training(_argv(root / "port"), device="cpu")
    return dict(root=root, summary=summary, jax_summary=jax_summary,
                rows=_rows(root / "port"), jax_rows=_rows(root / "jax"),
                trainer=seen["port"], jax_trainer=seen["jax"])


def test_cli_summaries_have_the_same_keys(cli_runs):
    assert set(cli_runs["summary"]) == set(cli_runs["jax_summary"])
    # new-style namespace: no flat aliases; QMF's df accuracy
    assert "test_epoch/test_avg_df_acc" in cli_runs["summary"]
    assert "avg_test_acc" not in cli_runs["summary"]


@pytest.mark.parametrize("kind", ["train_step", "val_step", "test_step",
                                  "epoch", "test_epoch"])
def test_cli_metrics_jsonl_rows_have_the_same_keys(cli_runs, kind):
    rows = [sorted(r) for r in cli_runs["rows"] if _row_kind(r) == kind]
    jax_rows = [sorted(r) for r in cli_runs["jax_rows"]
                if _row_kind(r) == kind]
    assert rows and rows == jax_rows
    if kind == "train_step":
        assert "train_step/train_df_acc" in rows[0]
    if kind == "val_step":
        assert "val_step/logits_df_acc" in rows[0]


def test_trainers_agree_epoch_by_epoch(cli_runs):
    port, jax_ = cli_runs["trainer"].history, cli_runs["jax_trainer"].history
    assert len(port) == len(jax_) == 2
    for epoch, (h, jh) in enumerate(zip(port, jax_)):
        for key in ("train_epoch/train_avg_loss", "val_epoch/val_avg_loss"):
            np.testing.assert_allclose(h[key], jh[key], rtol=LOSS_RTOL,
                                       err_msg=f"epoch {epoch} {key}")
        for key in ("val_epoch/val_avg_acc", "val_epoch/val_avg_df_acc",
                    "train_epoch/train_avg_acc",
                    "train_epoch/train_avg_df_acc"):
            assert h[key] == jh[key], (epoch, key)
    np.testing.assert_allclose(
        cli_runs["summary"]["test_epoch/test_avg_loss"],
        cli_runs["jax_summary"]["test_epoch/test_avg_loss"], rtol=LOSS_RTOL)


def test_trainers_end_with_the_same_qmf_history(cli_runs):
    """Crema-D tests the best checkpoint: both trainers end on it, History
    included."""
    state, jstate = cli_runs["trainer"].state, cli_runs["jax_trainer"].state
    assert state.step == int(jstate.step)
    assert state.step in (4, 8)
    for name in ("qmf_correctness", "qmf_confidence"):
        got, want = getattr(state, name), np.asarray(getattr(jstate, name))
        assert got.shape == want.shape == (2, 64)
        np.testing.assert_allclose(got.numpy(), want, rtol=TABLE_RTOL,
                                   atol=TABLE_ATOL, err_msg=name)


def test_cli_checkpoint_holds_the_tables_and_resumes(cli_runs, narrow):
    """The committed checkpoints hold both tables; ``--resume`` restores
    them as saved and trains one more epoch."""
    run_dir = cli_runs["root"] / "port"
    ckpt = run_dir / RUN_NAME / "ckpt"
    assert sorted(os.listdir(ckpt)) == ["best", "last-4", "last-8",
                                        "meta.json"]
    # the trainer ended on the best checkpoint, which the test restored
    best = torch.load(ckpt / "best" / "state.pt", weights_only=True)
    state = cli_runs["trainer"].state
    assert best["step"] == state.step
    for name in ("qmf_correctness", "qmf_confidence"):
        assert torch.equal(best[name], getattr(state, name))
    saved = torch.load(ckpt / "last-8" / "state.pt", weights_only=True)
    assert saved["qmf_correctness"].any()
    seen = {}

    class Watched(Trainer):
        def resume(self):
            found = super().resume()
            seen.update(corr=self.state.qmf_correctness.clone(),
                        conf=self.state.qmf_confidence.clone())
            return found

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_run, "Trainer", Watched)
        port_main.run_training(_argv(run_dir, "--resume", "--set",
                                     "num_epochs=3"), device="cpu")
    assert torch.equal(seen["corr"], saved["qmf_correctness"])
    assert torch.equal(seen["conf"], saved["qmf_confidence"])
    meta = json.loads((ckpt / "meta.json").read_text())
    assert meta["epochs_done"] == 3 and meta["meta_step"] == 12


# -- preemption --------------------------------------------------------------

class _InterruptAfter:
    """Loader wrapper that runs ``action`` when batch n is reached."""

    def __init__(self, inner, n, action):
        self.inner, self.n, self.action = inner, n, action

    def set_epoch(self, epoch):
        self.inner.set_epoch(epoch)

    def skip(self, n):
        self.inner.skip(n)

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        for i, b in enumerate(self.inner):
            if i == self.n:
                self.action()
            yield b


def _port_trainer(root):
    args = load_config("cremad", overrides=dict(
        model_type="qmf", num_epochs=2, batch_size=BATCH,
        compute_dtype="float32", log_every_n_steps=2, ckpt_dir=str(root),
        data_path=f"{root}/none"))
    data = cremad.get_data(args)
    spec, _ = cremad.get_model_spec(args, n_train=len(data.train))
    loaders = port_run.build_loaders(args, data, "cpu")
    state = create_train_state(spec, args, 0, len(loaders[0]), device="cpu")
    return Trainer(args, spec, state, *loaders)


def test_preempted_qmf_run_resumes_bit_equal(tmp_path, narrow):
    """SIGTERM mid-epoch, then ``--resume``: weights, BN buffers, momentum,
    EMA, step and both History tables end bit-equal to an uninterrupted
    run's."""
    ref = _port_trainer(tmp_path / "ref")
    ref.fit()

    pre = _port_trainer(tmp_path / "pre")
    pre.train_loader = _InterruptAfter(
        pre.train_loader, 2, lambda: os.kill(os.getpid(), signal.SIGTERM))
    with pytest.raises(Preempted) as exc:
        pre.fit()
    assert exc.value.code == 143 and exc.value.step == 3

    resumed = _port_trainer(tmp_path / "pre")
    assert resumed.resume()
    assert resumed.state.step == 3
    resumed.fit()
    a, b = resumed.state, ref.state
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert all(torch.equal(oa[k]["momentum_buffer"], ob[k]["momentum_buffer"])
               for k in oa)
    assert torch.equal(a.ema, b.ema) and a.step == b.step == 8
    assert torch.equal(a.qmf_correctness, b.qmf_correctness)
    assert torch.equal(a.qmf_confidence, b.qmf_confidence)
    assert a.qmf_correctness.any()
