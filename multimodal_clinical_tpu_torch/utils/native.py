"""ctypes bindings of the repository's native host library,
``native/libfastdata.so`` (port of ``multimodal_clinical_tpu/utils/
native.py``): the alias table of the weighted sampler, libjpeg decode with
resize or crop-and-resize, the ISO-BMFF demuxer for MJPEG and PCM
containers, and the int16 mixdown.

``make -C native`` builds the library (the JAX package's binding runs that
make itself); the port loads what is there and builds nothing.  When it
does not load (``OSError``: not built, or a library it links is missing,
as ``libjpeg.so.62`` on a machine without libjpeg-turbo), ``available()``
is False and every caller takes the path the JAX package takes then:
numpy draws in the sampler, PIL for JPEG frames, the numpy mixdown for
wavs, libav or nothing for mp4 audio."""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native", "libfastdata.so")

_DOUBLE_P = ctypes.POINTER(ctypes.c_double)
_INT64_P = ctypes.POINTER(ctypes.c_int64)
_INT32_P = ctypes.POINTER(ctypes.c_int32)
_UINT8_P = ctypes.POINTER(ctypes.c_uint8)
_FLOAT_P = ctypes.POINTER(ctypes.c_float)

_lib: Optional[ctypes.CDLL] = None
_tried = False
# the Loader's gather threads reach the first load together: a thread that
# saw the load half done would take the PIL path for its frames
_load_mutex = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    with _load_mutex:
        if not _tried:
            _lib = _bind()
            _tried = True
    return _lib


def _bind() -> Optional[ctypes.CDLL]:
    """The library with every entry point's argument types, as the JAX
    binding sets them (``utils/native.py:45-105``); None if it does not
    load."""
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError:
        return None
    lib.build_alias_table.argtypes = [_DOUBLE_P, ctypes.c_int64, _DOUBLE_P,
                                      _INT64_P]
    lib.build_alias_table.restype = None
    lib.alias_sample.argtypes = [_DOUBLE_P, _INT64_P, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_uint64, _INT64_P]
    lib.alias_sample.restype = None
    lib.pcm16_to_float_mono.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.c_int64, ctypes.c_int32,
        _FLOAT_P]
    lib.pcm16_to_float_mono.restype = None
    lib.decode_jpeg_resize.argtypes = [_UINT8_P, ctypes.c_int64,
                                       ctypes.c_int32, ctypes.c_int32,
                                       _FLOAT_P]
    lib.decode_jpeg_resize.restype = ctypes.c_int
    if hasattr(lib, "decode_jpeg_crop_resize"):
        lib.decode_jpeg_crop_resize.argtypes = [
            _UINT8_P, ctypes.c_int64, *[ctypes.c_int32] * 6, _FLOAT_P]
        lib.decode_jpeg_crop_resize.restype = ctypes.c_int
    lib.jpeg_dims.argtypes = [_UINT8_P, ctypes.c_int64, _INT32_P, _INT32_P]
    lib.jpeg_dims.restype = ctypes.c_int
    if hasattr(lib, "mp4_open"):
        lib.mp4_open.argtypes = [ctypes.c_char_p]
        lib.mp4_open.restype = ctypes.c_void_p
        lib.mp4_close.argtypes = [ctypes.c_void_p]
        lib.mp4_close.restype = None
        lib.mp4_track_count.argtypes = [ctypes.c_void_p]
        lib.mp4_track_count.restype = ctypes.c_int
        lib.mp4_track_info.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       _INT64_P]
        lib.mp4_track_info.restype = ctypes.c_int
        for name in ("mp4_sample_size", "mp4_sample_time"):
            getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int64]
            getattr(lib, name).restype = ctypes.c_int64
        lib.mp4_read_sample.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int64, _UINT8_P,
                                        ctypes.c_int64]
        lib.mp4_read_sample.restype = ctypes.c_int64
        lib.mp4_read_range.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int64, ctypes.c_int64,
                                       _UINT8_P, ctypes.c_int64]
        lib.mp4_read_range.restype = ctypes.c_int64
        lib.mp4_range_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int64, ctypes.c_int64]
        lib.mp4_range_bytes.restype = ctypes.c_int64
    return lib


def available() -> bool:
    return _load() is not None


class AliasTable:
    """Vose alias table over unnormalised weights; O(1) per draw."""

    def __init__(self, weights: np.ndarray):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"{LIB_PATH} does not load")
        w = np.ascontiguousarray(weights, np.float64)
        self.n = len(w)
        self.prob = np.empty(self.n, np.float64)
        self.alias = np.empty(self.n, np.int64)
        lib.build_alias_table(w.ctypes.data_as(_DOUBLE_P), self.n,
                              self.prob.ctypes.data_as(_DOUBLE_P),
                              self.alias.ctypes.data_as(_INT64_P))

    def sample(self, num_samples: int, seed: int) -> np.ndarray:
        out = np.empty(int(num_samples), np.int64)
        _load().alias_sample(
            self.prob.ctypes.data_as(_DOUBLE_P),
            self.alias.ctypes.data_as(_INT64_P), self.n, len(out),
            ctypes.c_uint64(seed & (2 ** 64 - 1)),
            out.ctypes.data_as(_INT64_P))
        return out


def _jpeg_bytes(path_or_bytes) -> np.ndarray:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return np.frombuffer(bytes(path_or_bytes), np.uint8)
    return np.fromfile(path_or_bytes, np.uint8)


def decode_jpeg(path_or_bytes, out_h: int, out_w: int
                ) -> Optional[np.ndarray]:
    """Decode a JPEG and resize it to (out_h, out_w): float32 RGB HWC in
    [0, 1], or None when the library does not load or the decode fails
    (callers then take PIL).  libjpeg's DCT-domain downscale first, so a
    large frame is never decoded whole."""
    lib = _load()
    if lib is None:
        return None
    data = _jpeg_bytes(path_or_bytes)
    out = np.empty((out_h, out_w, 3), np.float32)
    rc = lib.decode_jpeg_resize(data.ctypes.data_as(_UINT8_P), len(data),
                                out_h, out_w, out.ctypes.data_as(_FLOAT_P))
    return out if rc == 0 else None


def decode_jpeg_crop(path_or_bytes, box, out_h: int, out_w: int
                     ) -> Optional[np.ndarray]:
    """Decode, crop ``box = (left, top, right, bottom)`` in the original
    pixels and resize the crop to (out_h, out_w): the RandomResizedCrop
    decode, outside the interpreter lock.  float32 RGB HWC in [0, 1], or
    None (callers then take PIL)."""
    lib = _load()
    if lib is None or not hasattr(lib, "decode_jpeg_crop_resize"):
        return None
    data = _jpeg_bytes(path_or_bytes)
    out = np.empty((out_h, out_w, 3), np.float32)
    left, top, right, bottom = (int(v) for v in box)
    rc = lib.decode_jpeg_crop_resize(
        data.ctypes.data_as(_UINT8_P), len(data), left, top, right, bottom,
        out_h, out_w, out.ctypes.data_as(_FLOAT_P))
    return out if rc == 0 else None


def jpeg_dims(path_or_bytes) -> Optional[Tuple[int, int]]:
    """(height, width) from the JPEG header alone; None when the library
    does not load or the header does not parse."""
    lib = _load()
    if lib is None:
        return None
    data = _jpeg_bytes(path_or_bytes)
    h, w = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.jpeg_dims(data.ctypes.data_as(_UINT8_P), len(data),
                       ctypes.byref(h), ctypes.byref(w))
    return (h.value, w.value) if rc == 0 else None


def _fourcc(code: int) -> str:
    """int fourcc -> its four ASCII characters ('vide', 'jpeg', 'sowt')."""
    return bytes((code >> s) & 0xFF for s in (24, 16, 8, 0)).decode(
        "latin-1")


class Mp4File:
    """A handle of the native ISO-BMFF demuxer (``native/mp4_demux.cpp``):
    the ffmpeg-free container reader (the reference decodes containers
    with ffmpeg, cremad/video_preprocessing.py:36-76,
    vggsound/mp4_to_wav.py:26-44).

    ``tracks`` holds a dict per track: handler and codec fourcc, timescale,
    sample count and each kind's geometry.  Samples are read by index: an
    MJPEG video sample is a whole JPEG, PCM audio samples concatenate to
    the raw stream."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None or not hasattr(lib, "mp4_open"):
            raise RuntimeError(f"{LIB_PATH} does not load")
        self._lib = lib
        self._h = lib.mp4_open(path.encode())
        if not self._h:
            raise ValueError(f"not a parseable MP4/MOV: {path}")
        self.tracks = []
        info = (ctypes.c_int64 * 10)()
        for t in range(lib.mp4_track_count(self._h)):
            lib.mp4_track_info(self._h, t, info)
            self.tracks.append({
                "handler": _fourcc(info[0]), "codec": _fourcc(info[1]),
                "timescale": int(info[2]), "n_samples": int(info[3]),
                "width": int(info[4]), "height": int(info[5]),
                "channels": int(info[6]), "sample_rate": int(info[7]),
                "bits": int(info[8]), "duration": int(info[9]),
            })

    def close(self) -> None:
        if self._h:
            self._lib.mp4_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()

    def sample_times(self, track: int) -> np.ndarray:
        """Decode time of every sample of ``track``, in seconds."""
        tr = self.tracks[track]
        scale = max(tr["timescale"], 1)
        return np.asarray([self._lib.mp4_sample_time(self._h, track, i)
                           / scale for i in range(tr["n_samples"])],
                          np.float64)

    def read_sample(self, track: int, i: int) -> bytes:
        size = self._lib.mp4_sample_size(self._h, track, i)
        if size < 0:
            raise IndexError(f"sample {i} of track {track}")
        buf = np.empty(size, np.uint8)
        got = self._lib.mp4_read_sample(self._h, track, i,
                                        buf.ctypes.data_as(_UINT8_P), size)
        if got != size:
            raise IOError(f"short read ({got}) for sample {i}")
        return buf.tobytes()

    def read_range(self, track: int, i0: int, i1: int) -> np.ndarray:
        """The raw bytes of samples [i0, i1), concatenated (PCM in bulk)."""
        total = int(self._lib.mp4_range_bytes(self._h, track, i0, i1))
        if total < 0:
            raise IndexError(f"range [{i0}, {i1}) of track {track}")
        buf = np.empty(max(total, 1), np.uint8)
        got = self._lib.mp4_read_range(self._h, track, i0, i1,
                                       buf.ctypes.data_as(_UINT8_P), total)
        if got != total:
            raise IOError(f"short range read ({got} != {total})")
        return buf[:total]


#: the PCM audio codecs the native demuxer decodes (fourcc -> dtype);
#: compressed codecs (mp4a/AAC) need libav (``utils/avdecode.py``)
PCM_MP4_CODECS = {"sowt": "<i2", "twos": ">i2", "lpcm": "<i2", "raw ": "u1"}

#: the sample width each fourcc is decoded at (0 bits: the stsd entry left
#: it unset, taken as the codec's own width)
_PCM_BITS = {"sowt": 16, "twos": 16, "lpcm": 16, "raw ": 8}


def mp4_pcm_undecodable_reason(track: dict) -> Optional[str]:
    """None when ``read_mp4_pcm_mono`` decodes the audio track, else why
    not.  'lpcm' can carry 24-bit or float samples, which read as int16
    would be noise, so the width is checked beside the fourcc."""
    codec = track.get("codec")
    if codec not in PCM_MP4_CODECS:
        return (f"audio codec {codec!r} needs ffmpeg (native path decodes "
                "PCM only)")
    bits = int(track.get("bits") or 0)
    want = _PCM_BITS[codec]
    if bits not in (0, want):
        return (f"PCM codec {codec!r} with {bits}-bit samples "
                f"(native path decodes {want}-bit only)")
    return None


def read_mp4_pcm_mono(path: str) -> Tuple[np.ndarray, int]:
    """The first PCM audio track of an MP4/MOV as float32 mono:
    ``(audio, sample_rate)``.  Raises ``ValueError`` naming the codec when
    the track is compressed, or a width the native path does not decode."""
    with Mp4File(path) as m:
        tracks = [i for i, t in enumerate(m.tracks) if t["handler"] == "soun"]
        if not tracks:
            raise ValueError(f"{path}: no audio track")
        t = tracks[0]
        tr = m.tracks[t]
        reason = mp4_pcm_undecodable_reason(tr)
        if reason is not None:
            raise ValueError(f"{path}: {reason}")
        dtype = PCM_MP4_CODECS[tr["codec"]]
        raw = m.read_range(t, 0, tr["n_samples"]).tobytes()
    data = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    if dtype == "u1":
        data = (data - 128.0) / 128.0
    else:
        data = data / 32768.0
    ch = max(tr["channels"], 1)
    if ch > 1:
        data = data[: len(data) // ch * ch].reshape(-1, ch).mean(axis=1)
    sr = tr["sample_rate"] or tr["timescale"] or 16000
    return data.astype(np.float32), int(sr)


def resample_linear(audio: np.ndarray, sr: int, target_sr: int
                    ) -> np.ndarray:
    """Linear resample to ``target_sr`` (the identity when the rates
    match).  The reference resamples with librosa's default, so the two
    agree in distribution only."""
    if sr == target_sr or len(audio) <= 1:
        return np.asarray(audio, np.float32)
    n_out = int(len(audio) * target_sr / sr)
    return np.interp(np.linspace(0, len(audio) - 1, n_out),
                     np.arange(len(audio)), audio).astype(np.float32)


def pcm16_to_float_mono(pcm: np.ndarray, channels: int
                        ) -> Optional[np.ndarray]:
    """Interleaved int16 -> float32 mono in [-1, 1]; None when the library
    does not load (callers then mix down in numpy)."""
    lib = _load()
    if lib is None:
        return None
    pcm = np.ascontiguousarray(pcm, np.int16)
    frames = len(pcm) // channels
    out = np.empty(frames, np.float32)
    lib.pcm16_to_float_mono(pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                            frames, channels, out.ctypes.data_as(_FLOAT_P))
    return out
