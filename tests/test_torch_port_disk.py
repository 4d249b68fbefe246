"""The disk datasets of VGGSound, Crema-D (pkl and stream modes) and AVE
(pkl and stream modes) in the port against the JAX package on the CPU, on
small corpora in the reference's layouts (``benchmarks/disk_fixture.py``):
the gathers bit for bit, train and eval, for two (seed, epoch) pairs, over
1 and 3 of the Loader's gather threads, with the native host library
loaded and with it forced off in both packages (the PIL path the card
machine takes, where ``libjpeg.so.62`` is missing); ``get_data``'s splits,
labels, class maps and sampler kinds; and the VGGSound CLI on a disk
corpus, a run preempted and resumed against one that was not."""

import functools
import os
import signal
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.benchmarks import ave as jax_ave
from multimodal_clinical_tpu.benchmarks import cremad as jax_cremad
from multimodal_clinical_tpu.benchmarks import vggsound as jax_vggsound
from multimodal_clinical_tpu.utils import native as jax_native

import multimodal_clinical_tpu_torch.__main__ as port_main
from multimodal_clinical_tpu_torch.benchmarks import (
    ave, cremad, disk_fixture, vggsound,
)
from multimodal_clinical_tpu_torch.data.loader import Loader
from multimodal_clinical_tpu_torch.engine import run as port_run
from multimodal_clinical_tpu_torch.engine.trainer import Preempted, Trainer
from multimodal_clinical_tpu_torch.models import zoo as port_zoo
from multimodal_clinical_tpu_torch.models.resnet import ResNetEncoder
from multimodal_clinical_tpu_torch.models.zoo import CremadFusionNet
from multimodal_clinical_tpu_torch.utils import native

torch.set_num_threads(2)

SMALL = dict(frame_size=(40, 30), quality=90, distinct=4)
# (benchmark, mode) -> (port module, JAX module, get_data args)
CASES = {
    "vggsound": (vggsound, jax_vggsound, dict(num_classes=3,
                                              use_video_frames=3)),
    "cremad_pkl": (cremad, jax_cremad, dict(num_classes=6)),
    "cremad_stream": (cremad, jax_cremad, dict(num_classes=6)),
    "ave_pkl": (ave, jax_ave, dict(num_classes=28)),
    "ave_stream": (ave, jax_ave, dict(num_classes=28)),
}
SEED_EPOCHS = [(0, 0), (7, 3)]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One small corpus per case.  VGGSound: 1 s wavs (tiled to 10 s by
    the gather), 5 frames a clip; Crema-D: 0.5 s wavs, one clip with 2
    frames (the gather repeats the last); AVE: 7 frames, event windows."""
    root = tmp_path_factory.mktemp("disk")
    paths = {case: str(root / case) + "/" for case in CASES}
    disk_fixture.build_vggsound_tree(paths["vggsound"], 10, 6, 3,
                                     n_frames=5, seconds=1.0, **SMALL)
    for mode in ("pkl", "stream"):
        path = paths[f"cremad_{mode}"]
        disk_fixture.build_cremad_tree(path, 8, 6, mode, seconds=0.5,
                                       **SMALL)
        clip = sorted(os.listdir(os.path.join(path, "image")))[0]
        os.remove(os.path.join(path, "image", clip, "0002.jpg"))
        disk_fixture.build_ave_tree(paths[f"ave_{mode}"], 8, 6, 6, mode,
                                    n_classes=4, n_frames=7, seconds=10.0,
                                    **SMALL)
    return paths


@pytest.fixture(params=["native", "pil"])
def host_lib(request, monkeypatch):
    """``native``: both packages with ``native/libfastdata.so`` loaded
    (the port looks again after the JAX binding's make); ``pil``: both
    with it forced off."""
    if request.param == "native":
        if not jax_native.available():
            pytest.skip("native/libfastdata.so does not load here")
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", False)
        assert native.available()
    else:
        for module in (native, jax_native):
            monkeypatch.setattr(module, "_lib", None)
            monkeypatch.setattr(module, "_tried", True)
    return request.param


def _bundles(trees, case, seed):
    port, jax_mod, extra = CASES[case]
    args = SimpleNamespace(data_path=trees[case], seed=seed, **extra)
    return port.get_data(args), jax_mod.get_data(args)


def _splits(case):
    return ("train", "val", "test") if case.startswith("ave") else (
        "train", "test")


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_gathers_equal_jax(trees, host_lib, case, workers):
    """Train (crop, flip, frame picks) and eval gathers equal the JAX
    dataset's, key by key, dtype and bits, at indices with repeats, the
    port's split over ``workers`` gather threads by the Loader."""
    for seed, epoch in SEED_EPOCHS:
        got, want = _bundles(trees, case, seed)
        for split in _splits(case):
            ds, ref = getattr(got, split), getattr(want, split)
            ds.set_epoch(epoch)
            ref.set_epoch(epoch)
            idx = np.random.default_rng(seed + epoch).choice(len(ref), 8)
            loader = Loader(ds, 8, None, workers=workers, device="cpu")
            out, expect = loader._gather(idx), ref.gather(idx)
            assert out.keys() == expect.keys()
            for key in expect:
                assert out[key].dtype == expect[key].dtype, (split, key)
                np.testing.assert_array_equal(out[key], expect[key],
                                              err_msg=f"{split} {key}")
    if case == "vggsound":
        assert out["x2"].shape == (8, 3, 224, 224, 3)
        assert out["x1_waveform"].shape == (8, 80000)
    elif case.endswith("pkl"):
        assert out["x1"].shape == (8, 257, 1004, 1)


def test_pil_and_native_paths_differ_only_in_frames(trees, monkeypatch):
    """The native and PIL JPEG paths are not bit-equal, and no other key
    depends on which one ran: the gather holds the draws to one order."""
    got, _ = _bundles(trees, "vggsound", 0)
    idx = np.arange(4)
    if not jax_native.available():
        pytest.skip("native/libfastdata.so does not load here")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    with_native = got.train.gather(idx)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    with_pil = got.train.gather(idx)
    np.testing.assert_array_equal(with_native["x1_waveform"],
                                  with_pil["x1_waveform"])
    assert not np.array_equal(with_native["x2"], with_pil["x2"])


@pytest.mark.parametrize("case", list(CASES))
def test_get_data_splits_equal_jax(trees, case):
    got, want = _bundles(trees, case, 3)
    for field in ("train_sampler", "val_sampler", "test_sampler",
                  "synthetic"):
        assert getattr(got, field) == getattr(want, field), field
    assert (got.train_sampler, got.val_sampler, got.test_sampler) == (
        "weighted", "weighted", "sequential")
    assert not got.synthetic
    for split in ("train", "val", "test"):
        ds, ref = getattr(got, split), getattr(want, split)
        assert type(ds).__name__ == type(ref).__name__
        assert ds.items == ref.items and len(ds) == len(ref) > 0
        np.testing.assert_array_equal(ds.labels, ref.labels)
        assert ds.labels.dtype == ref.labels.dtype
        assert ds.train == ref.train == (split == "train")
        if hasattr(ref, "audio_mode"):
            assert ds.audio_mode == ref.audio_mode == case.split("_")[1]
    if not case.startswith("ave"):
        assert got.val is got.test  # the reference's val is its test set


def test_vggsound_class_map_is_grown_in_train_row_order(tmp_path):
    """Class ids follow the train rows' first appearances; a test row of
    a class the train split lacks is dropped; clip ids are zero-filled."""
    disk_fixture.build_vggsound_tree(str(tmp_path), 4, 3, 3, n_frames=2,
                                     seconds=0.2, **SMALL)
    rows = (tmp_path / "vggsound.csv").read_text().splitlines()
    rows = [rows[2], rows[0], rows[3], rows[1], *rows[4:],
            "ytnew,5,class never trained,test"]
    (tmp_path / "vggsound.csv").write_text("\n".join(rows) + "\n")
    args = SimpleNamespace(data_path=str(tmp_path) + "/", seed=0,
                           num_classes=3)
    got, want = vggsound.get_data(args), jax_vggsound.get_data(args)
    assert got.train.items == want.train.items
    assert got.test.items == want.test.items
    assert [label for _, label in got.train.items] == [0, 1, 1, 2]
    assert got.train.items[0][0] == "yt000002_000020"


# -- the CLI on a disk corpus --------------------------------------------

# width 16: PyTorch's CPU convolution backward crashes (heap corruption)
# on the 224 x 224 frames at widths 4 and 8
WIDTH, BATCH = 16, 4


class _InterruptAfter:
    """Loader wrapper that sends SIGTERM when batch n is reached."""

    def __init__(self, inner, n):
        self.inner, self.n = inner, n

    def set_epoch(self, epoch):
        self.inner.set_epoch(epoch)

    def skip(self, n):
        self.inner.skip(n)

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        for i, batch in enumerate(self.inner):
            if i == self.n:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch


def _cli(tree, ckpt, monkeypatch, preempt=False, resume=False):
    """``run_training`` on the disk corpus at width 16, one block a stage,
    one frame a clip, fp32, on the CPU; returns the trainer it built."""
    seen = {}

    class Captured(Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            if preempt:
                self.train_loader = _InterruptAfter(self.train_loader, 1)
            seen["trainer"] = self

    monkeypatch.setattr(port_run, "Trainer", Captured)
    argv = ["--dir", "vggsound", "--set", f"data_path={tree}",
            "--set", f"ckpt_dir={ckpt}", "--set", "num_epochs=2",
            "--set", f"batch_size={BATCH}", "--set", "num_classes=3",
            "--set", "use_video_frames=1", "--set", "compute_dtype=float32",
            "--set", "loader_workers=2", "--set", "log_every_n_steps=1"]
    port_main.run_training(argv + (["--resume"] if resume else []),
                           device="cpu")
    return seen["trainer"]


def test_cli_on_a_disk_corpus_resumes_bit_equal(tmp_path, monkeypatch):
    """``python -m multimodal_clinical_tpu_torch --dir vggsound --set
    data_path=<corpus>`` in process on the CPU: a run preempted by SIGTERM
    in its first epoch and resumed with ``--resume`` ends with the
    weights, BN buffers, momentum, EMA and step of a run that was not."""
    tree = str(tmp_path / "vggsound") + "/"
    disk_fixture.build_vggsound_tree(tree, 8, 4, 3, n_frames=3,
                                     seconds=0.5, **SMALL)
    monkeypatch.setattr(port_zoo, "ResNetEncoder",
                        functools.partial(ResNetEncoder,
                                          stage_sizes=(1, 1, 1, 1)))
    monkeypatch.setattr(vggsound, "CremadFusionNet",
                        functools.partial(CremadFusionNet, width=WIDTH))
    ref = _cli(tree, tmp_path / "ref", monkeypatch)
    with pytest.raises(Preempted):
        _cli(tree, tmp_path / "pre", monkeypatch, preempt=True)
    resumed = _cli(tree, tmp_path / "pre", monkeypatch, resume=True)
    a, b = resumed.state, ref.state
    assert a.step == b.step == 2 * (8 // BATCH)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    for k in ob["state"]:
        assert torch.equal(oa["state"][k]["momentum_buffer"],
                           ob["state"][k]["momentum_buffer"])
    assert torch.equal(a.ema, b.ema)
    assert isinstance(resumed.train_loader.dataset,
                      vggsound.VGGSoundDiskDataset)
