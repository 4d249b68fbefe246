"""Crema-D in the port against the JAX package on the CPU: the
``cremad_spectrogram`` front end (against JAX's and against scipy's
``signal.spectrogram`` pipeline), the QMF family of model types and the
OGM-GE + QMF hybrid (two train steps, the second with a padded tail, and
one eval step; see ``torch_port_contract_harness.py``), the device
preprocess and the synthetic twin."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.benchmarks import cremad as jax_cremad
from multimodal_clinical_tpu.data import synthetic as jax_syn
from multimodal_clinical_tpu.ops import spectrogram as jax_spectrogram
from multimodal_clinical_tpu_torch.benchmarks import cremad
from multimodal_clinical_tpu_torch.data import synthetic as port_syn
from multimodal_clinical_tpu_torch.data.imageops import (
    normalize_frames_device,
)
from multimodal_clinical_tpu_torch.ops.spectrogram import (
    _tukey_periodic, cremad_spectrogram,
)

import torch_port_contract_harness as H

torch.set_num_threads(2)

# the JAX test's tolerance against scipy (tests/test_ops.py): scipy runs
# the PSD in float64 from the fp32 waveform
SCIPY_TOL = 2e-3
# against the JAX function: both fp32, the port's DFT an FFT, JAX's a
# matmul; the standardised log-power agrees to a few ulps of its O(1)
# values, where bins of near-zero power turn an ulp of power into more
JAX_TOL = 5e-5


def _scipy_spectrogram(x, fs=16000):
    """The reference's offline pipeline (cremad/video_preprocessing.py:
    234-238): scipy.signal.spectrogram with its defaults -> log(+1e-7) ->
    standardise (std + 1e-9)."""
    from scipy import signal

    _, _, spec = signal.spectrogram(x, fs, nperseg=512, noverlap=353)
    spec = np.log(np.abs(spec) + 1e-7)
    return (spec - spec.mean()) / (spec.std() + 1e-9)


def _waves(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 0.3).astype(np.float32)
    x[0] += 0.25  # a DC offset, so the constant detrend matters
    return x


@pytest.mark.parametrize("shape", [(2, 32000), (1, 160000)])
def test_cremad_spectrogram_matches_scipy_and_jax(shape):
    x = _waves(shape, 3)
    got = cremad_spectrogram(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_spectrogram.cremad_spectrogram(jnp.asarray(x)))
    assert got.shape == want.shape
    if shape[1] == 160000:
        # 10 s at 16 kHz: the (257, 1004) of the reference's pickles
        assert got.shape == (1, 257, 1004)
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)
    for b in range(shape[0]):
        np.testing.assert_allclose(got[b], _scipy_spectrogram(x[b]),
                                   rtol=SCIPY_TOL, atol=SCIPY_TOL)
    # per-clip standardisation with the population std
    np.testing.assert_allclose(got.mean(axis=(1, 2)), 0.0, atol=1e-4)
    np.testing.assert_allclose(got.std(axis=(1, 2)), 1.0, atol=1e-4)


def test_tukey_window_is_scipys_and_jaxs():
    from scipy import signal

    np.testing.assert_array_equal(_tukey_periodic(512, 0.25),
                                  jax_spectrogram._tukey_periodic(512, 0.25))
    np.testing.assert_allclose(_tukey_periodic(512, 0.25),
                               signal.get_window(("tukey", 0.25), 512),
                               rtol=0, atol=1e-15)


SMALL = [(9, 11, 1), (3, 4, 4, 3)]

# the QMF family and the OGM-GE + QMF hybrid
CASES = {
    "qmf": {},
    "qmf_ablate": {},
    "qmf_ablate_Ljoint": {},
    "qmf_ablate_Lunimodal": {},
    "ogm_ge_lreg": dict(grad_mod_type="OGM_GE", alpha=0.8),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    return H.run_pair("cremad", request.param, **CASES[request.param])


def test_train_metrics_match_jax(run):
    H.check_train_metrics(run)
    assert "train_df_acc" in run["metrics"][0]


def test_params_bn_buffers_momentum_and_ema_match_jax(run):
    H.check_state(run)


def test_qmf_tables_match_jax(run):
    """The History tables after the two steps: equal to the JAX step's, and
    written at the batches' real ``idx`` only."""
    H.check_qmf_tables(run)


def test_eval_step_matches_jax(run):
    """Joint + unimodal + reg loss, with no scatter into the History."""
    H.check_eval(run)
    assert "df_acc" in run["out"]


def test_device_preprocess_is_the_composition():
    """The waveform becomes ``cremad_spectrogram``'s (B, 257, T, 1); uint8
    frames are normalised; nothing random, train or eval."""
    rng = np.random.default_rng(0)
    wave = torch.from_numpy(rng.normal(size=(2, 6713)).astype(np.float32))
    frames = torch.from_numpy(rng.integers(0, 256, (2, 3, 8, 8, 3),
                                           dtype=np.uint8))
    for train in (True, False):
        got = cremad.device_preprocess({"x1_waveform": wave, "x2": frames},
                                       None, train)
        assert set(got) == {"x1", "x2"}
        assert torch.equal(got["x1"], cremad_spectrogram(wave)[..., None])
        assert got["x1"].shape == (2, 257, 40, 1)
        assert torch.equal(got["x2"], normalize_frames_device(frames))
    spectrogram = torch.zeros(2, 5, 7, 1)
    got = cremad.device_preprocess({"x1": spectrogram, "x2": frames}, None,
                                   True)
    assert got["x1"] is spectrogram


def test_get_data_serves_the_jax_twin(tmp_path, monkeypatch):
    """The twin's published shapes (the (257, 1004) spectrogram, three
    frames); the draws compared at narrowed shapes."""
    assert port_syn.BENCHMARK_SHAPES["cremad"] == jax_syn.BENCHMARK_SHAPES[
        "cremad"] == [(257, 1004, 1), (3, 224, 224, 3)]
    for syn in (port_syn, jax_syn):
        monkeypatch.setitem(syn.BENCHMARK_SHAPES, "cremad", SMALL)
    args = SimpleNamespace(num_classes=6, seed=5,
                           data_path=str(tmp_path) + "/")
    data = cremad.get_data(args)
    want = jax_cremad.get_data(args)
    assert (data.train_sampler, data.val_sampler, data.test_sampler) == (
        "weighted", "weighted", "sequential")
    assert data.synthetic and want.synthetic
    for split in ("train", "val", "test"):
        got, ref = getattr(data, split), getattr(want, split)
        assert len(got) == len(ref)
        for a, b in zip(got.modalities, ref.modalities):
            assert a.shape[1:] == b.shape[1:]
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.labels, ref.labels)
    assert data.train.modalities[1].shape[1:] == SMALL[1]


def test_get_data_raises_naming_item_8b_for_the_disk_dataset(tmp_path):
    """Split files that admit no clip raise the JAX package's error in
    both packages (the disk dataset is ported; the name is kept)."""
    (tmp_path / "train.csv").write_text("clip,label\n")
    (tmp_path / "test.csv").write_text("clip,label\n")
    args = SimpleNamespace(num_classes=6, data_path=str(tmp_path) + "/")
    for module in (cremad, jax_cremad):
        with pytest.raises(FileNotFoundError,
                           match="train.csv exists but 0 clips were admitted"):
            module.get_data(args)
