"""Disk corpora of VGGSound, Crema-D and AVE in the reference's on-disk
layouts, made from a seed: what ``get_data`` reads where the real dataset
is present, for the tests and ``chip_smoke.py``.

Each writes a few dozen distinct JPEGs and waveforms once and then their
bytes under every clip's name, so a corpus of hundreds of clips takes
seconds.  The per-sample geometry is the caller's: the published one
(10 JPEGs of 640 x 360 a VGGSound clip at quality 93, the 1 FPS grid of
``tools/preprocess.py video-frames``; 10 s wavs at 16 kHz) or a small one
for the CPU tests.

- VGGSound (vggsound/get_data.py): ``vggsound.csv`` rows
  ``ytid,start,class,split``; ``audio/<ytid>_<start:06>.wav``;
  ``frames/<clip>/*.jpg``.
- Crema-D (cremad/get_data.py): ``train.csv`` / ``test.csv`` rows
  ``clip,EMOTION``; ``audio_spec/<clip>.pkl`` (257, 1004) float32 in pkl
  mode, ``audio/<clip>.wav`` in stream mode; ``image/<clip>/*.jpg``.
- AVE (ave/get_data.py): ``trainSet.txt`` / ``valSet.txt`` /
  ``testSet.txt`` and ``Annotations.txt`` rows ``Class&clip&good&start&
  end``; ``Audio-1004-SE/<clip>.pkl`` in pkl mode, ``Audios/<clip>.wav``
  in stream mode; ``Image-01-FPS-SE/<clip>/*.jpg``.

The pickles are what ``tools/preprocess.py cremad-audio`` computes: the
clip's wav tiled to 10 s (``_tile_clip_waveform``, or AVE's window) through
``ops/spectrogram.py::cremad_spectrogram``, here on the CPU.
"""

from __future__ import annotations

import io
import os
import pickle
import wave
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.spectrogram import cremad_spectrogram

SR = 16000
CREMAD_CLASSES = ("NEU", "HAP", "SAD", "FEA", "DIS", "ANG")


def jpeg_pool(seed: int, n: int, size: Tuple[int, int], quality: int
              ) -> List[bytes]:
    """``n`` distinct JPEGs of ``size`` = (width, height): smooth colour
    fields with grain, so a decode costs what a video frame's does."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    w, h = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for _ in range(n):
        fx, fy = rng.uniform(2 * np.pi / w, 12 * np.pi / w, 2)
        phase = rng.uniform(0, 2 * np.pi, 3)
        field = np.stack([np.sin(xx * fx + phase[c]) * np.cos(yy * fy)
                          for c in range(3)], axis=-1)
        img = 128 + 90 * field + rng.normal(0, 6, (h, w, 3))
        buf = io.BytesIO()
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            buf, "JPEG", quality=quality)
        out.append(buf.getvalue())
    return out


def wave_pool(seed: int, n: int, seconds: float) -> List[np.ndarray]:
    """``n`` distinct int16 mono waveforms at 16 kHz: two tones and
    noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    out = []
    for _ in range(n):
        f1, f2 = rng.uniform(80, 4000, 2)
        x = (0.3 * np.sin(2 * np.pi * f1 * t) + 0.2 * np.sin(2 * np.pi * f2 * t)
             + rng.normal(0, 0.05, len(t)))
        out.append((np.clip(x, -1, 1) * 32767).astype(np.int16))
    return out


def wav_bytes(pcm: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def _write(path: str, data: bytes) -> int:
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def _write_frames(dir_path: str, jpegs: Sequence[bytes], first: int,
                  count: int) -> int:
    os.makedirs(dir_path, exist_ok=True)
    return sum(_write(os.path.join(dir_path, f"{k:04d}.jpg"),
                      jpegs[(first + k) % len(jpegs)])
               for k in range(count))


def _pickles(waves: Sequence[np.ndarray]) -> List[bytes]:
    """The pickled (257, 1004) float32 spectrogram of each 10 s float32
    waveform, as ``tools/preprocess.py cremad-audio`` writes it."""
    spec = cremad_spectrogram(torch.from_numpy(np.stack(waves))).numpy()
    return [pickle.dumps(s.astype(np.float32)) for s in spec]


def build_vggsound_tree(root: str, n_train: int, n_test: int,
                        n_classes: int, n_frames: int = 10,
                        frame_size: Tuple[int, int] = (640, 360),
                        quality: int = 93, seconds: float = 10.0,
                        distinct: int = 32, seed: int = 0) -> Dict:
    """``vggsound.csv`` with ``n_train`` train rows over every one of
    ``n_classes`` class strings (cycled) and ``n_test`` test rows, a wav
    and ``n_frames`` JPEGs a clip.  Returns the clip and byte counts."""
    os.makedirs(os.path.join(root, "audio"), exist_ok=True)
    jpegs = jpeg_pool(seed, distinct, frame_size, quality)
    wavs = [wav_bytes(p) for p in wave_pool(seed + 1, distinct, seconds)]
    rows, nbytes = [], 0
    for i in range(n_train + n_test):
        split = "train" if i < n_train else "test"
        ytid, start = f"yt{i:06d}", 10 * (i % 7)
        clip = f"{ytid}_{start:06d}"
        rows.append(f"{ytid},{start},class {i % n_classes:03d},{split}\n")
        nbytes += _write(os.path.join(root, "audio", clip + ".wav"),
                         wavs[i % distinct])
        nbytes += _write_frames(os.path.join(root, "frames", clip), jpegs,
                                i, n_frames)
    with open(os.path.join(root, "vggsound.csv"), "w") as f:
        f.writelines(rows)
    return {"clips": n_train + n_test, "bytes": nbytes}


def build_cremad_tree(root: str, n_train: int, n_test: int, mode: str,
                      n_frames: int = 3,
                      frame_size: Tuple[int, int] = (480, 360),
                      quality: int = 93, seconds: float = 2.5,
                      distinct: int = 16, seed: int = 0) -> Dict:
    """``train.csv`` / ``test.csv`` over the six emotions, ``n_frames``
    JPEGs a clip, and per clip the pickle of its tiled wav (``mode``
    'pkl') or the wav itself ('stream').  The two modes of one seed hold
    the same clips, frames and audio."""
    from .cremad import _tile_clip_waveform

    pcm = wave_pool(seed + 1, distinct, seconds)
    if mode == "pkl":
        audio_dir, ext = "audio_spec", ".pkl"
        blobs = _pickles([_tile_clip_waveform(p / 32768.0, "")
                          for p in pcm])
    else:
        audio_dir, ext = "audio", ".wav"
        blobs = [wav_bytes(p) for p in pcm]
    os.makedirs(os.path.join(root, audio_dir), exist_ok=True)
    jpegs = jpeg_pool(seed, distinct, frame_size, quality)
    nbytes = 0
    for split, first, count in (("train", 0, n_train),
                                ("test", n_train, n_test)):
        rows = []
        for i in range(first, first + count):
            clip = f"{1001 + i // 12}_CLIP{i:04d}_{CREMAD_CLASSES[i % 6]}_XX"
            rows.append(f"{clip},{CREMAD_CLASSES[i % 6]}\n")
            nbytes += _write(os.path.join(root, audio_dir, clip + ext),
                             blobs[i % distinct])
            nbytes += _write_frames(os.path.join(root, "image", clip),
                                    jpegs, i, n_frames)
        with open(os.path.join(root, f"{split}.csv"), "w") as f:
            f.writelines(rows)
    return {"clips": n_train + n_test, "bytes": nbytes}


def build_ave_tree(root: str, n_train: int, n_val: int, n_test: int,
                   mode: str, n_classes: int = 28, n_frames: int = 10,
                   frame_size: Tuple[int, int] = (640, 360),
                   quality: int = 93, seconds: float = 10.0,
                   distinct: int = 16, seed: int = 0) -> Dict:
    """The three split lists and ``Annotations.txt`` over ``n_classes``
    events, each clip with an event window of 2-10 s; ``n_frames`` JPEGs
    a clip, and the pickle of the window's 10 s waveform (``mode`` 'pkl')
    or the whole clip's wav ('stream')."""
    from .ave import AveDiskDataset

    n = n_train + n_val + n_test
    windows = [(k % 5, k % 5 + 2 + k % 4) for k in range(distinct)]
    pcm = wave_pool(seed + 1, distinct, seconds)
    if mode == "pkl":
        audio_dir, ext = "Audio-1004-SE", ".pkl"
        cutter = AveDiskDataset("", [], False, segments={
            str(k): windows[k] for k in range(distinct)})
        blobs = _pickles([cutter._window_waveform(p / 32768.0, str(k))
                          for k, p in enumerate(pcm)])
    else:
        audio_dir, ext = "Audios", ".wav"
        blobs = [wav_bytes(p) for p in pcm]
    os.makedirs(os.path.join(root, audio_dir), exist_ok=True)
    jpegs = jpeg_pool(seed, distinct, frame_size, quality)
    rows, nbytes = [], 0
    for i in range(n):
        # a clip uses the audio of its index modulo ``distinct``, so its
        # window is that audio's (the pickles were cut on it)
        start, end = windows[i % distinct]
        clip = f"ave{i:05d}"
        rows.append(f"Event {i % n_classes:02d}&{clip}&good&{start}&{end}\n")
        nbytes += _write(os.path.join(root, audio_dir, clip + ext),
                         blobs[i % distinct])
        nbytes += _write_frames(os.path.join(root, "Image-01-FPS-SE", clip),
                                jpegs, i, n_frames)
    with open(os.path.join(root, "Annotations.txt"), "w") as f:
        f.writelines(["Category&VideoID&Quality&StartTime&EndTime\n",
                      *rows])
    for name, lo, hi in (("trainSet.txt", 0, n_train),
                         ("valSet.txt", n_train, n_train + n_val),
                         ("testSet.txt", n_train + n_val, n)):
        with open(os.path.join(root, name), "w") as f:
            f.writelines(rows[lo:hi])
    return {"clips": n, "bytes": nbytes}
