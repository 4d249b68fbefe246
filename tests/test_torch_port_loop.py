"""The port's loop against the JAX package's on the CPU: metric summaries,
checkpoints, the trainer and the CLI.

``python -m multimodal_clinical_tpu_torch --dir vggsound`` and the JAX
CLI run in process on the same synthetic twin, narrowed (modality shapes
and towers monkeypatched on both sides: width 4, one block per
stage), fp32: both write
``metrics.jsonl`` rows with the same keys per row kind.  The port's run
starts from the JAX run's initial weights (``load_jax_variables``), so the
two trainers' per-epoch losses, accuracies and final BN buffers are held
together too.  The twin ships its spectrogram as ``x1``, so the step draws
no SpecAugment mask, and the twin has no dropout: the two runs see the same
batches in the same order and no random draw.  Two correct fp32
implementations of these towers part where a ReLU or max-pool decision
sits within rounding of its threshold; the twin's seed-0 data and this
width cross no such threshold in the 8 steps of the two epochs on either
side, which the tolerances below (those of ``test_torch_port_step.py``)
would show.
"""

import functools
import json
import os
import signal
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_clinical_tpu.__main__ as jax_main
import multimodal_clinical_tpu.data.synthetic as jax_syn
import multimodal_clinical_tpu.engine.run as jax_run
from multimodal_clinical_tpu.engine import contracts as jax_contracts
from multimodal_clinical_tpu.engine import metrics as jax_metrics
from multimodal_clinical_tpu.models import resnet as jax_resnet
from multimodal_clinical_tpu.models import zoo as jax_zoo

import multimodal_clinical_tpu_torch.__main__ as port_main
import multimodal_clinical_tpu_torch.data.synthetic as port_syn
import multimodal_clinical_tpu_torch.engine.run as port_run
from multimodal_clinical_tpu_torch.benchmarks import vggsound
from multimodal_clinical_tpu_torch.engine import contracts, metrics
from multimodal_clinical_tpu_torch.engine.checkpoint import BestCheckpointer
from multimodal_clinical_tpu_torch.engine.spec import ModelSpec
from multimodal_clinical_tpu_torch.engine.state import create_train_state
from multimodal_clinical_tpu_torch.engine.steps import (
    make_scan_train_step, make_train_step,
)
from multimodal_clinical_tpu_torch.engine.trainer import Preempted, Trainer
from multimodal_clinical_tpu_torch.models.jax_weights import (
    get_leaf, jax_key_map, load_jax_variables, to_torch_layout,
)
from multimodal_clinical_tpu_torch.models import zoo as port_zoo
from multimodal_clinical_tpu_torch.models.resnet import ResNetEncoder
from multimodal_clinical_tpu_torch.models.zoo import CremadFusionNet
from multimodal_clinical_tpu_torch.ops import cuda_spectrogram
from multimodal_clinical_tpu_torch.utils import native

torch.set_num_threads(2)

WIDTH, CLASSES, BATCH = 4, 5, 16
STAGES = (1, 1, 1, 1)  # one block per stage: 12 BNs per tower
SHAPES = [(17, 20, 1), (2, 16, 16, 3)]
# see test_torch_port_step.py: fp32 on both sides, summed in another order
LOSS_RTOL = 1e-5
BUFFER_RTOL, BUFFER_ATOL = 1e-4, 1e-5
# the summaries run the same numpy arithmetic on the same step outputs
SUMMARY_RTOL = 1e-6


def _argv(root, *extra):
    return ["--dir", "vggsound", "--set", "num_epochs=2",
            "--set", f"batch_size={BATCH}", "--set", f"num_classes={CLASSES}",
            "--set", "log_every_n_steps=2", "--set", "compute_dtype=float32",
            "--set", f"ckpt_dir={root}", "--set", f"data_path={root}/none",
            *extra]


def _narrow(monkeypatch):
    """Both packages' VGGSound twin and towers, narrowed."""
    monkeypatch.setitem(jax_syn.BENCHMARK_SHAPES, "vggsound", SHAPES)
    monkeypatch.setitem(port_syn.BENCHMARK_SHAPES, "vggsound", SHAPES)
    monkeypatch.setattr(jax_zoo, "ResNetEncoder",
                        functools.partial(jax_resnet.ResNetEncoder,
                                          width=WIDTH, stage_sizes=STAGES))
    monkeypatch.setattr(port_zoo, "ResNetEncoder",
                        functools.partial(ResNetEncoder, stage_sizes=STAGES))
    monkeypatch.setattr(vggsound, "CremadFusionNet",
                        functools.partial(CremadFusionNet, width=WIDTH))


@pytest.fixture
def narrow(monkeypatch):
    _narrow(monkeypatch)


def _rows(run_dir):
    path = Path(run_dir) / "vggsound_cls309_jprobas_seeds" / "metrics.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def _row_kind(row):
    for prefix in ("train_step", "val_step", "test_step"):
        if any(k.startswith(prefix + "/") for k in row):
            return prefix
    return "test_epoch" if row.get("epoch") == -1 else "epoch"


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The two CLIs on the same twin, the port's from the JAX run's
    initial weights; their summaries, log rows and trainers."""
    root = tmp_path_factory.mktemp("cli")
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
        # one compiled program instead of op-by-op dispatch of every
        # initializer; the port loads whatever weights it draws
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
        launches = cuda_spectrogram.launch_log_spectrogram.launches
        summary = port_main.run_training(_argv(root / "port"), device="cpu")
        assert cuda_spectrogram.launch_log_spectrogram.launches == launches
    return dict(root=root, summary=summary, jax_summary=jax_summary,
                rows=_rows(root / "port"), jax_rows=_rows(root / "jax"),
                trainer=seen["port"], jax_trainer=seen["jax"])


def test_cli_summaries_have_the_same_keys(cli_runs):
    assert set(cli_runs["summary"]) == set(cli_runs["jax_summary"])
    assert "test_epoch/test_avg_acc" in cli_runs["summary"]


@pytest.mark.parametrize("kind", ["train_step", "val_step", "test_step",
                                  "epoch", "test_epoch"])
def test_cli_metrics_jsonl_rows_have_the_same_keys(cli_runs, kind):
    """Per row kind: the same number of rows and the same keys in each."""
    rows = [sorted(r) for r in cli_runs["rows"] if _row_kind(r) == kind]
    jax_rows = [sorted(r) for r in cli_runs["jax_rows"]
                if _row_kind(r) == kind]
    assert rows and rows == jax_rows


def test_cli_step_rows_are_at_the_same_steps(cli_runs):
    assert ([r.get("_step") for r in cli_runs["rows"]]
            == [r.get("_step") for r in cli_runs["jax_rows"]])


def test_trainers_agree_epoch_by_epoch(cli_runs):
    port, jax_ = cli_runs["trainer"].history, cli_runs["jax_trainer"].history
    assert len(port) == len(jax_) == 2
    for epoch, (h, jh) in enumerate(zip(port, jax_)):
        np.testing.assert_allclose(h["train_epoch/train_avg_loss"],
                                   jh["train_epoch/train_avg_loss"],
                                   rtol=LOSS_RTOL, err_msg=f"epoch {epoch}")
        np.testing.assert_allclose(h["val_epoch/val_avg_loss"],
                                   jh["val_epoch/val_avg_loss"],
                                   rtol=LOSS_RTOL, err_msg=f"epoch {epoch}")
        for key in ("val_epoch/val_avg_acc", "train_epoch/train_avg_acc",
                    "val_epoch/val_avg_x1_acc", "val_epoch/val_avg_x2_acc"):
            assert h[key] == jh[key], (epoch, key)
    np.testing.assert_allclose(
        cli_runs["summary"]["test_epoch/test_avg_loss"],
        cli_runs["jax_summary"]["test_epoch/test_avg_loss"], rtol=LOSS_RTOL)


def test_trainers_end_with_the_same_bn_buffers_and_step(cli_runs):
    state, jstate = cli_runs["trainer"].state, cli_runs["jax_trainer"].state
    stats = jax.tree_util.tree_map(np.asarray, jstate.batch_stats)
    sd = state.model.state_dict()
    checked = 0
    for key, (coll, path, kind) in jax_key_map(state.model).items():
        if coll == "batch_stats":
            np.testing.assert_allclose(
                sd[key].numpy(), to_torch_layout(kind, get_leaf(stats, path)),
                rtol=BUFFER_RTOL, atol=BUFFER_ATOL, err_msg=key)
            checked += 1
    assert checked == 2 * 12 * 2  # two towers, 12 BNs, mean and var
    assert state.step == int(jstate.step) == 8


def test_cli_checkpoint_and_resume_one_more_epoch(cli_runs, narrow):
    """The port's run left a committed checkpoint directory; ``--resume``
    with one more epoch trains exactly one more epoch."""
    ckpt = cli_runs["root"] / "port" / "vggsound_cls309_jprobas_seeds" / "ckpt"
    names = sorted(os.listdir(ckpt))
    assert names == ["best", "last-4", "last-8", "meta.json"], names
    meta = json.loads((ckpt / "meta.json").read_text())
    assert meta["epochs_done"] == 2 and meta["meta_step"] == 8
    port_main.run_training(_argv(cli_runs["root"] / "port", "--resume",
                                 "--set", "num_epochs=3"), device="cpu")
    meta = json.loads((ckpt / "meta.json").read_text())
    assert meta["epochs_done"] == 3 and meta["meta_step"] == 12
    rows = _rows(cli_runs["root"] / "port")
    epochs = [r["epoch"] for r in rows if _row_kind(r) == "epoch"]
    assert epochs == [0, 1, 2]
    assert [r["_step"] for r in rows if _row_kind(r) == "epoch"] == [4, 8, 12]


def test_cli_raises_without_cuda_unless_given_cpu(monkeypatch, tmp_path,
                                                  narrow):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_main.run_training(_argv(tmp_path))


# -- metric summaries ----------------------------------------------------

def _eval_outputs(rng, n_batches, b, m, c, ensemble=False):
    outputs = []
    for i in range(n_batches):
        valid = np.ones(b, np.float32)
        if i == n_batches - 1:
            valid[b // 2:] = 0.0
        o = {"loss": np.float32(rng.uniform(1, 3)),
             "acc": np.float32(rng.uniform()),
             "label": rng.integers(0, c, b).astype(np.int32),
             "valid": valid}
        if ensemble:
            for j in range(m):
                o[f"x{j + 1}_acc"] = np.float32(rng.uniform())
            o["count_joint"] = np.float32(rng.integers(0, b))
            o["df_acc"] = np.float32(rng.uniform())
        else:
            o["logits_stack"] = rng.normal(size=(b, m, c)).astype(np.float32)
        outputs.append(o)
    return outputs


def _close_summaries(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=SUMMARY_RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("prefix", ["val", "test"])
@pytest.mark.parametrize("ensemble", [False, True])
@pytest.mark.parametrize("as_tensors", [False, True])
def test_eval_and_legacy_summaries_match_jax(prefix, ensemble, as_tensors):
    outputs = _eval_outputs(np.random.default_rng(7), 3, 8, 2, 6, ensemble)
    port_outputs = ([{k: torch.from_numpy(np.asarray(v)) for k, v in o.items()}
                     for o in outputs] if as_tensors else outputs)
    got = metrics.eval_epoch_summary(port_outputs, prefix)
    want = jax_metrics.eval_epoch_summary(outputs, prefix)
    _close_summaries(got, want)
    _close_summaries(metrics.legacy_alias_summary(got, prefix),
                     jax_metrics.legacy_alias_summary(want, prefix))


def test_train_epoch_summary_matches_jax():
    rng = np.random.default_rng(3)
    acc, jacc = metrics.EpochAccumulator(), jax_metrics.EpochAccumulator()
    for k in (1, 3, 1):  # single steps and a stacked 3-step dispatch
        step = {"train_loss": rng.uniform(1, 3, k).astype(np.float32),
                "train_acc": rng.uniform(size=k).astype(np.float32),
                "train_x1_acc_uncal": rng.uniform(size=k).astype(np.float32),
                "valid_count": np.full(k, 8, np.float32),
                "count_x1": rng.integers(0, 8, k).astype(np.float32)}
        if k == 1:
            step = {key: v[0] for key, v in step.items()}
        acc.append({key: torch.as_tensor(v) for key, v in step.items()})
        jacc.append({key: jnp.asarray(v) for key, v in step.items()})
    assert acc.summary()["valid_count"] == 40.0
    _close_summaries(metrics.train_epoch_summary(acc),
                     jax_metrics.train_epoch_summary(jacc))


@pytest.mark.parametrize("key", ["train_x1_acc_uncal", "train_x3_acc_uncal",
                                 "train_loss", "train_x2_acc"])
def test_step_metric_name_matches_jax(key):
    assert (metrics.step_metric_name("train", key)
            == jax_metrics.step_metric_name("train", key))


def test_offset_correct_matches_jax():
    x = np.random.default_rng(1).normal(size=(9, 3, 7)).astype(np.float32)
    np.testing.assert_allclose(
        contracts.offset_correct(torch.from_numpy(x)).numpy(),
        np.asarray(jax_contracts.offset_correct(jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)


# -- checkpoints ---------------------------------------------------------

def _tiny_state(seed=0):
    spec = ModelSpec(module=CremadFusionNet(3, width=4), contract="jprobas")
    args = SimpleNamespace(num_classes=3, learning_rate=0.1)
    return create_train_state(spec, args, seed=seed, steps_per_epoch=2,
                              device="cpu")


def _equal_states(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for k in oa["state"]:
        assert torch.equal(oa["state"][k]["momentum_buffer"],
                           ob["state"][k]["momentum_buffer"])
    assert torch.equal(a.ema, b.ema)
    assert (a.step, a.seed) == (b.step, b.seed)


def _trained(state, steps=2):
    spec = ModelSpec(module=state.model, contract="jprobas")
    step = make_train_step(spec)
    rng = np.random.default_rng(0)
    batch = {"x1": torch.from_numpy(rng.normal(size=(4, 9, 11, 1))
                                    .astype(np.float32)),
             "x2": torch.from_numpy(rng.normal(size=(4, 1, 9, 9, 3))
                                    .astype(np.float32)),
             "label": torch.tensor([0, 1, 2, 0]), "valid": torch.ones(4)}
    for _ in range(steps):
        state, _ = step(state, batch)
    return state


def test_checkpoint_round_trip(tmp_path):
    state = _trained(_tiny_state(0))
    state.seed = 11
    ckpt = BestCheckpointer(str(tmp_path))
    ckpt.save_last(state, epochs_done=1, steps_per_epoch=2)
    fresh = _tiny_state(1)
    restored = BestCheckpointer(str(tmp_path)).restore_last(fresh)
    assert restored is fresh
    _equal_states(restored, state)


def test_checkpoint_keeps_top1_on_a_tie(tmp_path):
    ckpt = BestCheckpointer(str(tmp_path))
    first = _trained(_tiny_state(0))
    assert ckpt.maybe_save(first, 0.5)
    assert not ckpt.maybe_save(_tiny_state(1), 0.5)      # tie: kept
    assert not ckpt.maybe_save(_tiny_state(2), 0.25)
    best = BestCheckpointer(str(tmp_path)).restore_best(_tiny_state(3))
    _equal_states(best, first)
    assert ckpt.maybe_save(_tiny_state(4), 0.75)
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta["best_metric"] == 0.75


def test_checkpoint_keeps_the_last_n(tmp_path):
    ckpt = BestCheckpointer(str(tmp_path), keep_last=2)
    state = _tiny_state(0)
    for step in (3, 6, 9):
        state.step = step
        ckpt.save_last(state, epochs_done=step // 3, steps_per_epoch=3)
    assert sorted(os.listdir(tmp_path)) == ["last-6", "last-9", "meta.json"]
    assert BestCheckpointer(str(tmp_path)).restore_last(
        _tiny_state(1)).step == 9


@pytest.mark.parametrize("committed", [True, False])
def test_checkpoint_crash_between_pending_and_commit(tmp_path, committed):
    """A save that died after writing its pending directory: a committed
    pending checkpoint is promoted over the old one, an uncommitted one is
    swept and the old one kept."""
    ckpt = BestCheckpointer(str(tmp_path))
    old = _tiny_state(0)
    old.step = 2
    ckpt.save_last(old, epochs_done=1, steps_per_epoch=2)
    new = _trained(_tiny_state(1))
    new.step = 2
    pending = tmp_path / "last-2.pending"
    pending.mkdir()
    part = pending / "state.pt.part"
    from multimodal_clinical_tpu_torch.engine.checkpoint import state_to_tree

    torch.save(state_to_tree(new), part)
    if committed:
        part.rename(pending / "state.pt")
    restored = BestCheckpointer(str(tmp_path)).restore_last(_tiny_state(2))
    assert sorted(os.listdir(tmp_path)) == ["last-2", "meta.json"]
    _equal_states(restored, new if committed else old)


# -- the trainer: preemption, K-step dispatch ---------------------------

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


def _port_trainer(root, **overrides):
    """A port Trainer as ``run_benchmark`` builds it, on the narrowed
    twin, on the CPU."""
    from multimodal_clinical_tpu_torch.config import load_config

    args = load_config("vggsound", overrides=dict(
        num_epochs=2, batch_size=BATCH, num_classes=CLASSES,
        compute_dtype="float32", log_every_n_steps=2, ckpt_dir=str(root),
        data_path=f"{root}/none", **overrides))
    data = vggsound.get_data(args)
    spec, _ = vggsound.get_model_spec(args, n_train=len(data.train))
    loaders = port_run.build_loaders(args, data, "cpu")
    state = create_train_state(spec, args, 0, len(loaders[0]), device="cpu")
    return Trainer(args, spec, state, *loaders)


def test_preempted_run_resumes_bit_equal(tmp_path, narrow):
    """SIGTERM mid-epoch: a checkpoint at the next step boundary and
    ``Preempted`` (exit status 143); ``--resume`` then ends bit-equal to an
    uninterrupted run: weights, BN buffers, momentum, EMA and step."""
    ref = _port_trainer(tmp_path / "ref")
    ref.fit()

    pre = _port_trainer(tmp_path / "pre")
    pre.train_loader = _InterruptAfter(
        pre.train_loader, 2, lambda: os.kill(os.getpid(), signal.SIGTERM))
    with pytest.raises(Preempted) as exc:
        pre.fit()
    assert exc.value.code == 143
    assert exc.value.step == 3  # the step that was running when it came
    assert signal.getsignal(signal.SIGTERM) is not pre._handle_preempt_signal

    resumed = _port_trainer(tmp_path / "pre")
    assert resumed.resume()
    assert resumed.state.step == 3 and resumed.ckpt.steps_into_epoch == 3
    resumed.fit()
    _equal_states(resumed.state, ref.state)


def test_k_step_dispatch_equals_single_steps(tmp_path, narrow):
    """``steps_per_dispatch`` 3 over 4-batch epochs (one call of 3, then a
    single-step tail) ends where single steps end, with the same epoch
    summaries and log steps."""
    single = _port_trainer(tmp_path / "single")
    single.fit()
    multi = _port_trainer(tmp_path / "multi", steps_per_dispatch=3)
    multi.fit()
    _equal_states(multi.state, single.state)
    for h, hm in zip(single.history, multi.history):
        for key in h:
            if "time" not in key and "per_sec" not in key:
                assert h[key] == hm[key], key


def test_scan_step_stacks_metrics():
    state = _tiny_state(0)
    spec = ModelSpec(module=state.model, contract="jprobas")
    batch = {"x1": torch.randn(2, 9, 11, 1), "x2": torch.randn(2, 1, 9, 9, 3),
             "label": torch.tensor([0, 1]), "valid": torch.ones(2)}
    state, m = make_scan_train_step(spec, 2)(state, batch, batch)
    assert state.step == 2
    assert all(v.shape == (2,) for v in m.values())
    with pytest.raises(ValueError, match="expected 2 batches"):
        make_scan_train_step(spec, 2)(state, batch)


def test_overfit_batches_and_ckpt_every_n_steps(tmp_path, narrow):
    trainer = _port_trainer(tmp_path, overfit_batches=2, ckpt_every_n_steps=1)
    trainer.fit()
    assert len(trainer.train_loader) == 2 and trainer.state.step == 4
    assert trainer.val_loader is trainer.train_loader
    # mid-epoch saves at steps 1 and 3, boundary saves at 2 and 4; the
    # last two are kept
    names = sorted(os.listdir(trainer.ckpt.ckpt_dir))
    assert names == ["best", "last-3", "last-4", "meta.json"], names


def test_profile_dir_traces_the_second_epoch(tmp_path, narrow):
    trainer = _port_trainer(tmp_path / "run")
    trainer.profile_dir = str(tmp_path / "prof")
    trainer.fit()
    assert os.listdir(tmp_path / "prof") == ["trace_epoch1.json"]


def test_eval_loader_epoch_ticks_each_pass(tmp_path, narrow):
    trainer = _port_trainer(tmp_path)
    epochs = []
    set_epoch = trainer.val_loader.set_epoch
    trainer.val_loader.set_epoch = lambda e: (epochs.append(e), set_epoch(e))
    trainer.fit()
    trainer.test(restore_best=False)
    assert epochs == [0, 1] and trainer._eval_pass == 2
