"""The port's bindings of ``native/libfastdata.so`` against the JAX
package's on the CPU: libjpeg decode with resize and with crop and
resize, the header's dims, the int16 mixdown, the linear resample, and the
ISO-BMFF demuxer (``Mp4File``, ``read_mp4_pcm_mono``) on MJPEG + PCM
containers made by the small muxer below (a copy of
``tests/test_native_mp4.py``'s); then a VGGSound clip whose audio streams
from such a container, gathered by both packages."""

import io
import os
import struct
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_clinical_tpu.benchmarks import vggsound as jax_vggsound
from multimodal_clinical_tpu.utils import avdecode as jax_avdecode
from multimodal_clinical_tpu.utils import native as jax_native

from multimodal_clinical_tpu_torch.benchmarks import disk_fixture, vggsound
from multimodal_clinical_tpu_torch.utils import avdecode, native

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def native_on(monkeypatch):
    """Both packages with the library loaded: the port looks again after
    the JAX binding's make (which builds it where it is missing)."""
    if not jax_native.available():
        pytest.skip("native/libfastdata.so does not load here")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.available()


# -- a minimal MP4 muxer: one MJPEG video track and one 'sowt' (s16le)
# PCM audio track, each in a single chunk -----------------------------------

def _box(tag: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I", 8 + len(body)) + tag + body


def _full(tag: bytes, *payload: bytes, version=0, flags=0) -> bytes:
    return _box(tag, struct.pack(">I", (version << 24) | flags), *payload)


def _tkhd(track_id, duration, w=0, h=0):
    return _full(b"tkhd", struct.pack(
        ">IIII4xI8xHHHH36xII", 0, 0, track_id, 0, duration,
        0, 0, 0, 0, w << 16, h << 16), flags=7)


def _mdhd(timescale, duration):
    return _full(b"mdhd", struct.pack(">IIIIHH", 0, 0, timescale, duration,
                                      0x55C4, 0))


def _hdlr(handler: bytes):
    return _full(b"hdlr", struct.pack(">4x4s12x", handler) + b"h\x00")


def _stts(count, delta):
    return _full(b"stts", struct.pack(">III", 1, count, delta))


def _stsc(per_chunk):
    return _full(b"stsc", struct.pack(">IIII", 1, 1, per_chunk, 1))


def _stsz_sized(sizes):
    return _full(b"stsz", struct.pack(">II", 0, len(sizes)) +
                 b"".join(struct.pack(">I", s) for s in sizes))


def _stsz_uniform(size, count):
    return _full(b"stsz", struct.pack(">II", size, count))


def _stco(offset):
    return _full(b"stco", struct.pack(">II", 1, offset))


def _video_entry(w, h):
    return _box(b"jpeg", struct.pack(
        ">6xH2x2x12xHHIIIH32sHh",
        1, w, h, 0x00480000, 0x00480000, 0, 1, b"\x00" * 32, 24, -1))


def _audio_entry(channels, rate):
    return _box(b"sowt", struct.pack(
        ">6xH8xHHHHI", 1, channels, 16, 0, 0, rate << 16))


def _trak(entry, tkhd, mdhd, hdlr, header, stts, stsc, stsz, stco):
    stbl = _box(b"stbl", _full(b"stsd", struct.pack(">I", 1), entry),
                stts, stsc, stsz, stco)
    dinf = _box(b"dinf", _full(b"dref", struct.pack(">I", 1),
                               _full(b"url ", flags=1)))
    minf = _box(b"minf", header, dinf, stbl)
    return _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, minf))


def write_mp4(path, jpeg_frames, fps, pcm_s16le, channels, rate):
    """Mux MJPEG frames (one sample each) + one PCM track into an MP4."""
    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 512), b"isomiso2")
    video_payload = b"".join(jpeg_frames)
    audio_payload = np.ascontiguousarray(pcm_s16le, "<i2").tobytes()
    mdat = _box(b"mdat", video_payload + audio_payload)
    video_off = len(ftyp) + 8
    audio_off = video_off + len(video_payload)
    n_pcm = len(pcm_s16le) // channels

    w, h = Image.open(io.BytesIO(jpeg_frames[0])).size
    vmhd = _full(b"vmhd", struct.pack(">HHHH", 0, 0, 0, 0), flags=1)
    smhd = _full(b"smhd", struct.pack(">Hxx", 0))
    v = _trak(_video_entry(w, h), _tkhd(1, len(jpeg_frames), w, h),
              _mdhd(int(round(fps)), len(jpeg_frames)), _hdlr(b"vide"),
              vmhd, _stts(len(jpeg_frames), 1), _stsc(len(jpeg_frames)),
              _stsz_sized([len(f) for f in jpeg_frames]), _stco(video_off))
    a = _trak(_audio_entry(channels, rate), _tkhd(2, n_pcm),
              _mdhd(rate, n_pcm), _hdlr(b"soun"), smhd,
              _stts(n_pcm, 1), _stsc(n_pcm),
              _stsz_uniform(2 * channels, n_pcm), _stco(audio_off))
    mvhd = _full(b"mvhd", struct.pack(
        ">IIIIIH10x36x24xI", 0, 0, 1000, 0, 0x00010000, 0x0100, 3))
    moov = _box(b"moov", mvhd, v, a)
    with open(path, "wb") as f:
        f.write(ftyp + mdat + moov)


def _pcm(seed, rate, channels, seconds):
    rng = np.random.default_rng(seed)
    return (rng.normal(scale=0.2, size=int(rate * seconds) * channels)
            * 32767).clip(-32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def jpegs():
    return disk_fixture.jpeg_pool(3, 3, (70, 46), 90)


@pytest.fixture(params=[(16000, 1), (22050, 2)], ids=["16k-mono",
                                                       "22k-stereo"])
def mp4_file(request, tmp_path, jpegs):
    rate, channels = request.param
    path = str(tmp_path / "clip.mp4")
    write_mp4(path, jpegs, fps=2.0, pcm_s16le=_pcm(7, rate, channels, 1.5),
              channels=channels, rate=rate)
    return path


# -- JPEG ------------------------------------------------------------------

@pytest.mark.parametrize("out_hw", [(224, 224), (17, 40), (46, 70)])
def test_decode_jpeg_matches(tmp_path, jpegs, out_hw):
    path = tmp_path / "f.jpg"
    path.write_bytes(jpegs[0])
    for src in (str(path), jpegs[0], bytearray(jpegs[1])):
        got = native.decode_jpeg(src, *out_hw)
        want = jax_native.decode_jpeg(src, *out_hw)
        assert got.dtype == np.float32 and got.shape == (*out_hw, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("box", [(0, 0, 70, 46), (5, 3, 40, 30),
                                 (69, 45, 70, 46), (10, 0, 31, 46)])
def test_decode_jpeg_crop_matches(jpegs, box):
    got = native.decode_jpeg_crop(jpegs[2], box, 224, 224)
    np.testing.assert_array_equal(
        got, jax_native.decode_jpeg_crop(jpegs[2], box, 224, 224))


def test_jpeg_dims_and_refused_bytes_match(tmp_path, jpegs):
    path = tmp_path / "f.jpg"
    path.write_bytes(jpegs[1])
    assert native.jpeg_dims(str(path)) == jax_native.jpeg_dims(
        str(path)) == (46, 70)
    garbage = b"\xff\xd8not a jpeg at all"
    for fn, args in ((native.jpeg_dims, ()), (native.decode_jpeg, (8, 8)),
                     (native.decode_jpeg_crop, ((0, 0, 4, 4), 8, 8))):
        jax_fn = getattr(jax_native, fn.__name__)
        assert fn(garbage, *args) is None and jax_fn(garbage, *args) is None


# -- PCM and resampling -------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 2, 6])
def test_pcm16_to_float_mono_matches(channels):
    pcm = _pcm(channels, 16000, channels, 0.3)
    got = native.pcm16_to_float_mono(pcm, channels)
    assert got.dtype == np.float32 and len(got) == len(pcm) // channels
    np.testing.assert_array_equal(got,
                                  jax_native.pcm16_to_float_mono(pcm,
                                                                 channels))


@pytest.mark.parametrize("sr,target,n", [(16000, 16000, 500),
                                         (44100, 16000, 4410),
                                         (8000, 16000, 800),
                                         (22050, 16000, 1)])
def test_resample_linear_matches(sr, target, n):
    audio = np.random.default_rng(n).normal(size=n).astype(np.float32)
    got = native.resample_linear(audio, sr, target)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_native.resample_linear(
        audio, sr, target))


# -- the ISO-BMFF demuxer -----------------------------------------------------

def test_mp4file_tracks_and_samples_match(mp4_file, jpegs):
    with native.Mp4File(mp4_file) as m, jax_native.Mp4File(mp4_file) as j:
        assert m.tracks == j.tracks
        assert [t["handler"] for t in m.tracks] == ["vide", "soun"]
        for t in range(len(m.tracks)):
            np.testing.assert_array_equal(m.sample_times(t),
                                          j.sample_times(t))
        assert [m.read_sample(0, i) for i in range(3)] == jpegs
        n = m.tracks[1]["n_samples"]
        np.testing.assert_array_equal(m.read_range(1, 0, n),
                                      j.read_range(1, 0, n))
        np.testing.assert_array_equal(m.read_range(1, 7, 300),
                                      j.read_range(1, 7, 300))
        with pytest.raises(IndexError):
            m.read_sample(0, 99)


def test_read_mp4_pcm_mono_matches(mp4_file):
    audio, sr = native.read_mp4_pcm_mono(mp4_file)
    want, want_sr = jax_native.read_mp4_pcm_mono(mp4_file)
    assert sr == want_sr and audio.dtype == np.float32
    np.testing.assert_array_equal(audio, want)


def test_mp4_refuses_what_the_jax_binding_refuses(tmp_path):
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"\x00\x00\x00\x08junkjunk")
    for module in (native, jax_native):
        with pytest.raises(ValueError, match="not a parseable MP4/MOV"):
            module.Mp4File(str(bad))


@pytest.mark.parametrize("track", [
    {"codec": "sowt", "bits": 16}, {"codec": "twos", "bits": 0},
    {"codec": "lpcm", "bits": 24}, {"codec": "raw ", "bits": 8},
    {"codec": "raw ", "bits": 16}, {"codec": "mp4a", "bits": 16},
    {"codec": None}])
def test_mp4_pcm_undecodable_reason_matches(track):
    assert native.mp4_pcm_undecodable_reason(track) == (
        jax_native.mp4_pcm_undecodable_reason(track))


def test_vggsound_streams_pcm_audio_from_the_container(tmp_path,
                                                       monkeypatch):
    """A clip without ``audio/<clip>.wav`` but with a PCM
    ``video/<clip>.mp4`` and extracted frames is admitted, and its audio
    comes through the native demuxer (libav forced off in both packages),
    resampled to 16 kHz: gathers equal the JAX package's."""
    for module in (avdecode, jax_avdecode):
        monkeypatch.setattr(module, "_lib", None)
        monkeypatch.setattr(module, "_tried", True)
    root = str(tmp_path) + "/"
    disk_fixture.build_vggsound_tree(root, 3, 2, 2, n_frames=3,
                                     seconds=0.4, frame_size=(40, 30),
                                     quality=90, distinct=2)
    os.makedirs(os.path.join(root, "video"))
    for clip in ("yt000000_000000", "yt000003_000030"):
        os.remove(os.path.join(root, "audio", clip + ".wav"))
        write_mp4(os.path.join(root, "video", clip + ".mp4"),
                  disk_fixture.jpeg_pool(1, 2, (40, 30), 90), 1.0,
                  _pcm(9, 22050, 2, 0.7), 2, 22050)
    args = SimpleNamespace(data_path=root, seed=4, num_classes=2,
                           use_video_frames=2)
    got, want = vggsound.get_data(args), jax_vggsound.get_data(args)
    assert got.train.items == want.train.items and len(got.train) == 3
    assert got.test.items == want.test.items and len(got.test) == 2
    for split in ("train", "test"):
        idx = np.arange(len(getattr(want, split)))
        out = getattr(got, split).gather(idx)
        expect = getattr(want, split).gather(idx)
        for key in expect:
            np.testing.assert_array_equal(out[key], expect[key])
