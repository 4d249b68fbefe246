"""The port's binding of ``native/libavdecode.so`` against the JAX
package's on the CPU, on real H.264 + AAC files that the module's own
encoder writes: the header probe, the decoder census, audio at the
stream's rate and resampled, frames at their size and rescaled, the
``-vf fps`` tick grid over whole clips and segments, and the encoder
itself; then the zero-offline-stage corpora, where every clip is a
container alone: VGGSound's audio and frames, Crema-D's stream mode and
AVE's event windows, gathered by both packages.

Every test skips where ``libavdecode.so`` does not load (no FFmpeg
runtime), as ``tests/test_avdecode.py`` does; the decision is made in a
fixture."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.benchmarks import ave as jax_ave
from multimodal_clinical_tpu.benchmarks import cremad as jax_cremad
from multimodal_clinical_tpu.benchmarks import vggsound as jax_vggsound
from multimodal_clinical_tpu.utils import avdecode as jax_avdecode

from multimodal_clinical_tpu_torch.benchmarks import ave, cremad, vggsound
from multimodal_clinical_tpu_torch.utils import avdecode

torch.set_num_threads(2)

FPS, SR = 4, 16000
COLORS = [(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0),
          (0, 255, 255), (255, 0, 255), (128, 64, 32), (32, 128, 64),
          (64, 32, 128), (200, 200, 200), (30, 30, 30), (90, 180, 250)]


@pytest.fixture(autouse=True)
def libav(monkeypatch):
    if not jax_avdecode.available():
        pytest.skip("libavdecode.so does not load here (no FFmpeg runtime)")
    monkeypatch.setattr(avdecode, "_lib", None)
    monkeypatch.setattr(avdecode, "_tried", False)
    assert avdecode.available()


def _frames(n=len(COLORS), h=48, w=64):
    return np.stack([np.full((h, w, 3), COLORS[i % len(COLORS)], np.uint8)
                     for i in range(n)])


def _tone(seconds, hz=440.0):
    t = np.arange(int(SR * seconds), dtype=np.float32) / SR
    return (0.5 * np.sin(2 * np.pi * hz * t)).astype(np.float32)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """12 flat-colour frames at 4 FPS (3 s) and a 3 s tone, H.264 + AAC,
    written by the JAX package's encoder."""
    if not jax_avdecode.available():
        pytest.skip("libavdecode.so does not load here (no FFmpeg runtime)")
    path = str(tmp_path_factory.mktemp("av") / "clip.mp4")
    jax_avdecode.encode_mp4(path, _frames(), FPS, _tone(3.0), SR)
    return path


def test_probe_and_census_match(clip, tmp_path):
    info = avdecode.probe(clip)
    assert info == jax_avdecode.probe(clip)
    assert (info["video_codec"], info["audio_codec"]) == ("h264", "aac")
    garbage = tmp_path / "garbage.mp4"
    garbage.write_bytes(os.urandom(2048))
    assert avdecode.probe(str(garbage)) is jax_avdecode.probe(
        str(garbage)) is None
    for name in ("h264", "aac", "hevc", "opus", "mjpeg", "nosuchcodec"):
        assert avdecode.has_decoder(name) == jax_avdecode.has_decoder(name)
    for name in ("libx264", "aac", "nosuchcodec"):
        assert avdecode.has_encoder(name) == jax_avdecode.has_encoder(name)
    for fourcc in (*avdecode.FOURCC_TO_FFMPEG, "zzzz"):
        assert avdecode.can_decode_fourcc(fourcc) == (
            jax_avdecode.can_decode_fourcc(fourcc)), fourcc
    for path in (clip, str(garbage)):
        for media in ("audio", "video"):
            assert avdecode.can_decode_stream(path, media) == (
                jax_avdecode.can_decode_stream(path, media))


@pytest.mark.parametrize("target_sr", [0, SR, 8000])
def test_read_audio_mono_matches(clip, target_sr):
    audio, sr = avdecode.read_audio_mono(clip, target_sr)
    want, want_sr = jax_avdecode.read_audio_mono(clip, target_sr)
    assert sr == want_sr and audio.dtype == np.float32
    np.testing.assert_array_equal(audio, want)


def test_refused_files_raise_as_jax(tmp_path):
    missing = str(tmp_path / "missing.mp4")
    for module in (avdecode, jax_avdecode):
        with pytest.raises(ValueError):
            module.read_audio_mono(missing)
        with pytest.raises(ValueError):
            list(module.iter_frames(missing))
        assert module.video_duration(missing) == 0.0


@pytest.mark.parametrize("size", [None, (32, 24)])
def test_frames_match(clip, size):
    got = list(avdecode.iter_frames(clip, size))
    want = list(jax_avdecode.iter_frames(clip, size))
    assert len(got) == len(want) == len(COLORS)
    for (frame, pts), (ref, ref_pts) in zip(got, want):
        assert pts == ref_pts
        np.testing.assert_array_equal(frame, ref)
    assert avdecode.video_duration(clip) == jax_avdecode.video_duration(clip)


@pytest.mark.parametrize("fps,start,end", [
    (1.0, 0.0, None), (FPS, 0.0, None), (1.0, 0.5, 2.0), (3.0, 1.0, 3.0),
    (1.0, 1.0, 1.0), (1.0, 2.0, 0.5), (2.5, 0.25, 10.0)])
def test_tick_grid_matches(clip, fps, start, end):
    got = list(avdecode.decode_frames_at_fps(clip, fps, start=start,
                                             end=end))
    want = list(jax_avdecode.decode_frames_at_fps(clip, fps, start=start,
                                                  end=end))
    assert [t for _, t in got] == [t for _, t in want]
    for (frame, _), (ref, _) in zip(got, want):
        np.testing.assert_array_equal(frame, ref)


def test_encoder_matches(tmp_path):
    """The port's encoder writes the JAX package's file: the same bytes
    (x264 and the aac encoder are deterministic for one input), so the
    same decoded frames and audio."""
    mine, theirs = str(tmp_path / "port.mp4"), str(tmp_path / "jax.mp4")
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (6, 32, 48, 3), dtype=np.uint8)
    avdecode.encode_mp4(mine, frames, 2, _tone(1.0, 300.0), SR)
    jax_avdecode.encode_mp4(theirs, frames, 2, _tone(1.0, 300.0), SR)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for (a, pa), (b, pb) in zip(jax_avdecode.iter_frames(mine),
                                jax_avdecode.iter_frames(theirs)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jax_avdecode.read_audio_mono(mine)[0],
                                  jax_avdecode.read_audio_mono(theirs)[0])
    with pytest.raises(ValueError):
        avdecode.encode_mp4(str(tmp_path / "x.mp4"), frames, 2, None, SR,
                            vcodec="nosuchcodec")


# -- the zero-offline-stage corpora -------------------------------------------

def _equal_gathers(got, want, splits, epochs=(0, 2)):
    for split in splits:
        ds, ref = getattr(got, split), getattr(want, split)
        assert ds.items == ref.items and len(ds) > 0
        for epoch in epochs:
            ds.set_epoch(epoch)
            ref.set_epoch(epoch)
            idx = np.arange(len(ref))
            out, expect = ds.gather(idx), ref.gather(idx)
            assert out.keys() == expect.keys()
            for key in expect:
                assert out[key].dtype == expect[key].dtype
                np.testing.assert_array_equal(out[key], expect[key],
                                              err_msg=f"{split} {key}")


def _encode_clips(video_dir, names, seconds=2.0):
    os.makedirs(video_dir, exist_ok=True)
    rng = np.random.default_rng(11)
    for k, name in enumerate(names):
        frames = rng.integers(0, 256, (int(FPS * seconds), 36, 48, 3),
                              dtype=np.uint8)
        avdecode.encode_mp4(os.path.join(video_dir, name + ".mp4"), frames,
                            FPS, _tone(seconds, 200.0 + 60 * k), SR)


@pytest.mark.parametrize("seed", [0, 3])
def test_vggsound_streams_audio_and_frames_from_containers(tmp_path, seed):
    """No wavs and no frame dirs: each clip's audio (AAC through libav)
    and its 1 FPS frames come from ``video/<clip>.mp4``."""
    rows = [("ytA", 0, "dog", "train"), ("ytB", 10, "cat", "train"),
            ("ytC", 20, "dog", "train"), ("ytD", 30, "cat", "test"),
            ("ytE", 40, "dog", "test")]
    (tmp_path / "vggsound.csv").write_text(
        "".join(f"{y},{s},{c},{sp}\n" for y, s, c, sp in rows))
    _encode_clips(str(tmp_path / "video"),
                  [f"{y}_{s:06d}" for y, s, _, _ in rows])
    args = SimpleNamespace(data_path=str(tmp_path) + "/", seed=seed,
                           num_classes=2, use_video_frames=3)
    got, want = vggsound.get_data(args), jax_vggsound.get_data(args)
    assert len(got.train) == 3 and len(got.test) == 2
    _equal_gathers(got, want, ("train", "test"))


def test_cremad_stream_mode_from_containers(tmp_path):
    """Crema-D with ``train.csv`` / ``test.csv`` and containers only: the
    per-clip probe admits every clip, the tiled 10 s waveform and the
    first three ticks' frames stream from the container."""
    clips = [f"1001_IEO_{c}_XX" for c in ("NEU", "HAP", "SAD", "FEA",
                                          "ANG")]
    _encode_clips(str(tmp_path / "video"), clips, seconds=1.5)
    (tmp_path / "train.csv").write_text(
        "".join(f"{c},{c.split('_')[2]}\n" for c in clips[:3]))
    (tmp_path / "test.csv").write_text(
        "".join(f"{c},{c.split('_')[2]}\n" for c in clips[3:]))
    args = SimpleNamespace(data_path=str(tmp_path) + "/", seed=1,
                           num_classes=6)
    got, want = cremad.get_data(args), jax_cremad.get_data(args)
    assert got.train.audio_mode == want.train.audio_mode == "stream"
    assert len(got.train) == 3 and len(got.test) == 2
    _equal_gathers(got, want, ("train", "test"))


def test_ave_event_windows_from_containers(tmp_path):
    """AVE with the split lists, ``Annotations.txt`` and ``AVE/<clip>.mp4``
    only: each clip's [start, end) audio window tiled to 10 s, and its
    window's frames at the raised tick rate of a short event."""
    clips = ["clipA", "clipB", "clipC", "clipD"]
    _encode_clips(str(tmp_path / "AVE"), clips, seconds=3.0)
    rows = ["Dog&clipA&good&0&2", "Bell&clipB&good&1&3",
            "Dog&clipC&good&0&1", "Bell&clipD&good&2&3"]
    (tmp_path / "Annotations.txt").write_text(
        "category&video&quality&start&end\n" + "\n".join(rows) + "\n")
    (tmp_path / "trainSet.txt").write_text("\n".join(rows[:2]) + "\n")
    (tmp_path / "valSet.txt").write_text(rows[2] + "\n")
    (tmp_path / "testSet.txt").write_text("\n".join(rows[2:]) + "\n")
    args = SimpleNamespace(data_path=str(tmp_path) + "/", seed=2,
                           num_classes=28)
    got, want = ave.get_data(args), jax_ave.get_data(args)
    assert got.train.audio_mode == "stream"
    _equal_gathers(got, want, ("train", "val", "test"))
