"""ctypes bindings of the libav decode module ``native/libavdecode.so``
(``native/av_decode.cpp``; port of ``multimodal_clinical_tpu/utils/
avdecode.py``).

The reference shells out to ffmpeg, OpenCV or moviepy to decode H.264 and
AAC (cremad/video_preprocessing.py:36-76, vggsound/mp4_to_wav.py:26-44,
ave/mp4_to_wav.py:8-39); the module decodes in process through the FFmpeg
libraries.  ``make -C native`` builds it where the FFmpeg headers are (the
JAX package's binding runs that make itself); the port loads what is there
and builds nothing.  When it does not load (not built, or the FFmpeg
runtime is missing) every entry point reports unavailable, and callers take
the native demuxer's MJPEG and PCM paths or admit no container clip.

  - ``read_audio_mono(path, target_sr)`` -> (float32 mono, sr);
  - ``iter_frames(path, size)`` yields (RGB uint8 H x W x 3, pts seconds);
  - ``decode_frames_at_fps(path, fps, ...)``: ffmpeg's ``-vf fps`` grid;
  - ``probe(path)``: codecs and geometry from the header;
  - ``encode_mp4``: writes real H.264 + AAC files, for test fixtures.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native", "libavdecode.so")

_INT_P = ctypes.POINTER(ctypes.c_int)
_DOUBLE_P = ctypes.POINTER(ctypes.c_double)
_UINT8_P = ctypes.POINTER(ctypes.c_uint8)
_FLOAT_P = ctypes.POINTER(ctypes.c_float)

_lib: Optional[ctypes.CDLL] = None
_tried = False
_load_mutex = threading.Lock()  # the Loader's gather threads load together


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
    """The library with the argument types the JAX binding sets; None if
    it does not load."""
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError:
        return None
    lib.avd_error_msg.argtypes = []
    lib.avd_error_msg.restype = ctypes.c_char_p
    lib.avd_has_decoder.argtypes = [ctypes.c_char_p]
    lib.avd_has_decoder.restype = ctypes.c_int
    lib.avd_has_encoder.argtypes = [ctypes.c_char_p]
    lib.avd_has_encoder.restype = ctypes.c_int
    lib.avd_can_decode_stream.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.avd_can_decode_stream.restype = ctypes.c_int
    lib.avd_probe.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int, _INT_P, _INT_P, _DOUBLE_P, _DOUBLE_P, _INT_P, _INT_P]
    lib.avd_probe.restype = ctypes.c_int
    lib.avd_open_video.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_int]
    lib.avd_open_video.restype = ctypes.c_void_p
    lib.avd_video_dims.argtypes = [ctypes.c_void_p, _INT_P, _INT_P]
    lib.avd_video_dims.restype = None
    lib.avd_video_duration.argtypes = [ctypes.c_void_p]
    lib.avd_video_duration.restype = ctypes.c_double
    lib.avd_next_frame.argtypes = [ctypes.c_void_p, _UINT8_P, _DOUBLE_P]
    lib.avd_next_frame.restype = ctypes.c_int
    lib.avd_close.argtypes = [ctypes.c_void_p]
    lib.avd_close.restype = None
    lib.avd_decode_audio.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.POINTER(_FLOAT_P), _INT_P]
    lib.avd_decode_audio.restype = ctypes.c_longlong
    lib.avd_free.argtypes = [ctypes.c_void_p]
    lib.avd_free.restype = None
    lib.avd_encode_mp4.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _UINT8_P, _FLOAT_P, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p]
    lib.avd_encode_mp4.restype = ctypes.c_int
    return lib


def available() -> bool:
    """True when ``libavdecode.so`` loaded (the FFmpeg runtime with it)."""
    return _load() is not None


def _err(lib) -> str:
    msg = lib.avd_error_msg()
    return msg.decode("utf-8", "replace") if msg else "unknown libav error"


#: ISO-BMFF sample-entry fourcc -> FFmpeg codec name, for codec verdicts
#: from a header the native demuxer read
FOURCC_TO_FFMPEG = {
    "avc1": "h264", "avc3": "h264", "h264": "h264",
    "hvc1": "hevc", "hev1": "hevc",
    "mp4v": "mpeg4", "xvid": "mpeg4", "XVID": "mpeg4",
    "vp08": "vp8", "vp09": "vp9", "av01": "av1",
    "jpeg": "mjpeg", "mjpa": "mjpeg", "mjpb": "mjpeg",
    "MJPG": "mjpeg", "mjpg": "mjpeg",
    "mp4a": "aac", "Opus": "opus", "opus": "opus",
    "fLaC": "flac", "flac": "flac",
    ".mp3": "mp3", "mp4a.40.34": "mp3",
    "ac-3": "ac3", "ec-3": "eac3",
    "sowt": "pcm_s16le", "twos": "pcm_s16be", "lpcm": "pcm_s16le",
    "raw ": "pcm_u8",
}


def can_decode_fourcc(fourcc: str) -> bool:
    """True when libavcodec has a decoder for the codec behind an ISO-BMFF
    sample-entry fourcc."""
    name = FOURCC_TO_FFMPEG.get(fourcc)
    return name is not None and has_decoder(name)


def has_decoder(name: str) -> bool:
    """True when libavcodec has a decoder of this FFmpeg short name."""
    lib = _load()
    return lib is not None and bool(lib.avd_has_decoder(name.encode()))


def has_encoder(name: str) -> bool:
    lib = _load()
    return lib is not None and bool(lib.avd_has_encoder(name.encode()))


def can_decode_stream(path: str, media: str) -> bool:
    """Whether the file's ``media`` stream ('video' or 'audio') decodes:
    the decoder resolved by codec id as the decode paths resolve it, so a
    decoder from an external library counts.  Reads the header only."""
    lib = _load()
    return lib is not None and bool(lib.avd_can_decode_stream(
        path.encode(), 0 if media == "video" else 1))


def probe(path: str) -> Optional[dict]:
    """Codec names, geometry, duration and audio rate from the header;
    None when the container does not parse or has no A/V stream."""
    lib = _load()
    if lib is None:
        return None
    vname = ctypes.create_string_buffer(64)
    aname = ctypes.create_string_buffer(64)
    w, h, sr, ch = (ctypes.c_int(0) for _ in range(4))
    dur, fps = ctypes.c_double(0), ctypes.c_double(0)
    rc = lib.avd_probe(path.encode(), vname, 64, aname, 64,
                       ctypes.byref(w), ctypes.byref(h), ctypes.byref(dur),
                       ctypes.byref(fps), ctypes.byref(sr), ctypes.byref(ch))
    if rc != 0:
        return None
    return {
        "video_codec": vname.value.decode() or None,
        "audio_codec": aname.value.decode() or None,
        "width": w.value, "height": h.value,
        "duration": dur.value, "fps": fps.value,
        "sample_rate": sr.value, "channels": ch.value,
    }


def read_audio_mono(path: str, target_sr: int = 0
                    ) -> Tuple[np.ndarray, int]:
    """The best audio stream as float32 mono: (audio, sample rate).
    ``target_sr`` 0 keeps the stream's rate; otherwise swresample converts.
    Raises ``ValueError`` on failure, as ``native.read_mp4_pcm_mono``
    does, so callers can chain the two."""
    lib = _load()
    if lib is None:
        raise ValueError(f"{path}: {LIB_PATH} does not load")
    buf = _FLOAT_P()
    sr_out = ctypes.c_int(0)
    n = lib.avd_decode_audio(path.encode(), int(target_sr),
                             ctypes.byref(buf), ctypes.byref(sr_out))
    if n < 0:
        raise ValueError(f"{path}: {_err(lib)}")
    try:
        out = np.ctypeslib.as_array(buf, shape=(int(n),)).astype(np.float32)
    finally:
        lib.avd_free(buf)
    return out, int(sr_out.value)


class _OpenVideo:
    """A live decode handle: the frame iterator and the header's duration
    from one container open.  Each gather opens its own: no handle is
    shared between threads."""

    def __init__(self, path: str, size: Optional[Tuple[int, int]] = None):
        lib = _load()
        if lib is None:
            raise ValueError(f"{path}: {LIB_PATH} does not load")
        self._lib = lib
        self._path = path
        out_w, out_h = size if size else (0, 0)
        self._h = lib.avd_open_video(path.encode(), int(out_w), int(out_h))
        if not self._h:
            raise ValueError(f"{path}: {_err(lib)}")

    def duration(self) -> float:
        """The container's or stream's duration in seconds (0.0 unknown)."""
        return float(self._lib.avd_video_duration(self._h))

    def frames(self) -> Iterator[Tuple[np.ndarray, float]]:
        w, h = ctypes.c_int(0), ctypes.c_int(0)
        self._lib.avd_video_dims(self._h, ctypes.byref(w), ctypes.byref(h))
        frame = np.empty((h.value, w.value, 3), np.uint8)
        pts = ctypes.c_double(0)
        while True:
            rc = self._lib.avd_next_frame(
                self._h, frame.ctypes.data_as(_UINT8_P), ctypes.byref(pts))
            if rc == 0:
                return
            if rc < 0:
                raise ValueError(f"{self._path}: {_err(self._lib)}")
            yield frame.copy(), float(pts.value)

    def close(self) -> None:
        if self._h:
            self._lib.avd_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def iter_frames(path: str, size: Optional[Tuple[int, int]] = None
                ) -> Iterator[Tuple[np.ndarray, float]]:
    """Decoded video frames as (RGB uint8 (H, W, 3), pts seconds);
    ``size`` = (width, height) rescales each frame, None keeps it."""
    with _OpenVideo(path, size) as v:
        yield from v.frames()


def video_duration(path: str) -> float:
    """The stream's duration in seconds (0.0 when the container does not
    say, or does not open)."""
    try:
        with _OpenVideo(path) as v:
            return v.duration()
    except ValueError:
        return 0.0


def decode_frames_at_fps(path: str, fps: float, start: float = 0.0,
                         end: Optional[float] = None,
                         size: Optional[Tuple[int, int]] = None):
    """Frames on ffmpeg's ``-vf fps`` grid: one a 1/fps tick in [start,
    end), each tick taking the nearest preceding decoded frame (the
    reference's ffmpeg fps filter, cremad/video_preprocessing.py:36-76).

    ``end`` None reads the duration from the open handle; an explicit
    ``end <= start`` is an empty segment and yields nothing.  Yields (RGB
    uint8 (H, W, 3), tick seconds)."""
    if end is not None and end <= start:
        return
    with _OpenVideo(path, size) as v:
        duration_known = end is not None
        if end is None:
            end = v.duration()
            duration_known = end > start
        it = v.frames()
        nxt = next(it, None)
        if nxt is None:
            return
        cur, cur_pts = nxt
        nxt = next(it, None)
        n_out = 0
        tick = start
        while True:
            # advance so that `cur` is the nearest frame with pts <= tick
            # (the first frame for ticks before it)
            while nxt is not None and nxt[1] <= tick + 1e-9:
                cur, cur_pts = nxt
                nxt = next(it, None)
            if duration_known:
                if tick >= end:
                    break
            elif nxt is None and tick >= cur_pts + 1.0 / fps - 1e-9:
                # no duration in the header: the grid ends one frame
                # duration past the last decoded frame
                break
            yield cur, tick
            n_out += 1
            tick = start + n_out / fps


def encode_mp4(path: str, frames: Optional[np.ndarray], fps: int,
               audio: Optional[np.ndarray], sample_rate: int,
               vcodec: str = "libx264", acodec: str = "aac") -> None:
    """Write a real mp4 (H.264 + AAC by default) from RGB uint8 frames
    (N, H, W, 3) and/or float32 mono audio: fixtures for the decode
    paths' tests."""
    lib = _load()
    if lib is None:
        raise ValueError(f"{LIB_PATH} does not load")
    n_frames, w, h = 0, 0, 0
    rgb_ptr = None
    if frames is not None and len(frames):
        frames = np.ascontiguousarray(frames, np.uint8)
        n_frames, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
        rgb_ptr = frames.ctypes.data_as(_UINT8_P)
    n_samples = 0
    audio_ptr = None
    if audio is not None and len(audio):
        audio = np.ascontiguousarray(audio, np.float32)
        n_samples = len(audio)
        audio_ptr = audio.ctypes.data_as(_FLOAT_P)
    rc = lib.avd_encode_mp4(path.encode(), w, h, n_frames, int(fps),
                            rgb_ptr, audio_ptr, n_samples, int(sample_rate),
                            vcodec.encode(), acodec.encode())
    if rc != 0:
        raise ValueError(f"{path}: {_err(lib)}")
