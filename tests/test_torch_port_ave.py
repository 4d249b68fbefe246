"""AVE's three model types and VGGSound's jlogits and ensemble in the port
against the JAX package on the CPU: two train steps (the second with a
padded tail) and one eval step from the same weights, with the
SpecAugment masks injected on both sides (see
``torch_port_contract_harness.py``); the specs, AVE's device preprocess
and synthetic twin."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.benchmarks import ave as jax_ave
from multimodal_clinical_tpu.benchmarks import vggsound as jax_vggsound
from multimodal_clinical_tpu.data import synthetic as jax_syn
from multimodal_clinical_tpu_torch.benchmarks import ave, vggsound
from multimodal_clinical_tpu_torch.data import synthetic as port_syn
from multimodal_clinical_tpu_torch.data.imageops import (
    normalize_frames_device,
)
from multimodal_clinical_tpu_torch.engine.state import step_generator
from multimodal_clinical_tpu_torch.models.zoo import CremadFusionNet
from multimodal_clinical_tpu_torch.ops.specaugment import (
    apply_masks, spec_augment_masks,
)
from multimodal_clinical_tpu_torch.ops.spectrogram import cremad_spectrogram

import torch_port_contract_harness as H

torch.set_num_threads(2)

SMALL = [(9, 11, 1), (6, 4, 4, 3)]

CASES = [("ave", t) for t in ave.MODEL_TYPES] + [
    ("vggsound", "jlogits"), ("vggsound", "ensemble")]


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def run(request):
    return H.run_pair(*request.param)


def test_train_metrics_match_jax(run):
    H.check_train_metrics(run)


def test_params_bn_buffers_momentum_and_ema_match_jax(run):
    H.check_state(run)


def test_eval_step_matches_jax(run):
    H.check_eval(run)
    H.check_qmf_tables(run)


@pytest.mark.parametrize("bench,port,jax_mod", [
    ("ave", ave, jax_ave), ("vggsound", vggsound, jax_vggsound)])
@pytest.mark.parametrize("model_type", ["jlogits", "jprobas", "ensemble"])
def test_model_specs_equal_the_jax_specs(bench, port, jax_mod, model_type):
    """The legacy schedulers and flags (AVE: StepLR(10, 0.5); VGGSound:
    StepLR(30, 0.5); both test the final weights and log the flat
    aliases); the legacy ensembles train on the mean."""
    args = SimpleNamespace(num_classes=7, model_type=model_type)
    spec, opt = port.get_model_spec(args, n_train=20)
    want, jopt = jax_mod.get_model_spec(args, n_train=20)
    assert H.spec_fields(spec) == H.spec_fields(want)
    assert opt == jopt == {}
    assert spec.device_preprocess is port.device_preprocess
    assert isinstance(spec.module, CremadFusionNet)
    assert not spec.test_restore_best and spec.legacy_metric_aliases
    assert spec.ensemble_train_mean == (model_type == "ensemble")


@pytest.mark.parametrize("port", [ave, vggsound])
def test_model_spec_raises_for_an_unknown_type(port):
    with pytest.raises(NotImplementedError, match="nosuch"):
        port.get_model_spec(SimpleNamespace(num_classes=3,
                                            model_type="nosuch"), 10)


def test_ave_device_preprocess_is_the_composition():
    """The waveform becomes ``cremad_spectrogram``'s; at train one
    frequency mask (width < 15) and one time mask (width < 60) drawn from
    the step's generator; uint8 frames normalised."""
    rng = np.random.default_rng(0)
    wave = torch.from_numpy(rng.normal(size=(3, 6713)).astype(np.float32))
    frames = torch.from_numpy(rng.integers(0, 256, (3, 6, 8, 8, 3),
                                           dtype=np.uint8))
    batch = {"x1_waveform": wave, "x2": frames}
    got = ave.device_preprocess(batch, step_generator(3, 7), True)
    spec2d = cremad_spectrogram(wave)
    fmask, tmask = spec_augment_masks(step_generator(3, 7), 3,
                                      *spec2d.shape[1:], "cpu",
                                      freq_mask_param=15, time_mask_param=60,
                                      num_freq_masks=1, num_time_masks=1)
    assert set(got) == {"x1", "x2"}
    assert torch.equal(got["x1"], apply_masks(spec2d, fmask, tmask)[..., None])
    assert torch.equal(got["x2"], normalize_frames_device(frames))
    assert ((1 - fmask).sum(1) < 15).all() and ((1 - tmask).sum(1) < 60).all()
    evaluated = ave.device_preprocess(batch, None, False)
    assert torch.equal(evaluated["x1"], spec2d[..., None])
    # a spectrogram x1 (the twin, the pickles) is masked the same way
    twin = ave.device_preprocess({"x1": spec2d[..., None], "x2": frames},
                                 step_generator(3, 7), True)
    assert torch.equal(twin["x1"], got["x1"])


def test_ave_get_data_serves_the_jax_twin(tmp_path, monkeypatch):
    """The twin's published shapes, six frames a clip
    (ave/get_data.py:135); the draws compared at narrowed shapes."""
    assert port_syn.BENCHMARK_SHAPES["ave"] == jax_syn.BENCHMARK_SHAPES[
        "ave"] == [(257, 1004, 1), (6, 224, 224, 3)]
    for syn in (port_syn, jax_syn):
        monkeypatch.setitem(syn.BENCHMARK_SHAPES, "ave", SMALL)
    args = SimpleNamespace(num_classes=28, seed=5,
                           data_path=str(tmp_path) + "/")
    data, want = ave.get_data(args), jax_ave.get_data(args)
    assert (data.train_sampler, data.val_sampler, data.test_sampler) == (
        "weighted", "weighted", "sequential")
    for split in ("train", "val", "test"):
        got, ref = getattr(data, split), getattr(want, split)
        for a, b in zip(got.modalities, ref.modalities):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.labels, ref.labels)
    assert data.train.modalities[1].shape[1:] == SMALL[1]


def test_ave_get_data_raises_naming_item_8b_for_the_disk_dataset(tmp_path):
    """A split list that admits no clip raises the JAX package's error in
    both packages (the disk dataset is ported; the name is kept)."""
    (tmp_path / "testSet.txt").write_text("Church bell&clip&good&0&10\n")
    args = SimpleNamespace(num_classes=28, data_path=str(tmp_path) + "/")
    for module in (ave, jax_ave):
        with pytest.raises(FileNotFoundError,
                           match="trainSet.txt: 0 clips admitted"):
            module.get_data(args)
