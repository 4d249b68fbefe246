"""Disk corpora of VGGSound, Crema-D, AVE, Enrico and FakeNews in the
reference's on-disk layouts, made from a seed: what ``get_data`` reads where the real dataset
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

- Enrico (enrico/get_data.py): ``design_topics.csv`` rows
  ``screen_id,topic`` (the two ids the reference ignores included),
  ``screenshots/<id>.jpg`` and ``wireframes/<id>.png``.
- FakeNews (fakenews/get_data.py, fakenews/model.py): ``{train,validate,
  test}.tsv`` rows ``id``, ``clean_title``, ``6_way_label`` (a few
  without an image), ``images/<id>.jpg``, a WordPiece ``vocab.txt``, and
  the embed variants' dataframe pickles ``{train,val,test}__text_image[
  _dialogue]_dataframe.pkl`` ({"id", "embedding", "label"[,
  "dialogue_embedding"]}, as ``tools/preprocess.py fakenews-embed``
  writes them).

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


def png_pool(seed: int, n: int, size: Tuple[int, int]) -> List[bytes]:
    """``n`` distinct PNG wireframes of ``size`` = (width, height): flat
    boxes on white, as Enrico's are."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    w, h = size
    out = []
    for _ in range(n):
        img = np.full((h, w, 3), 255, np.uint8)
        for _ in range(8):
            x0, y0 = rng.integers(0, w - 2), rng.integers(0, h - 2)
            x1 = rng.integers(x0 + 1, w)
            y1 = rng.integers(y0 + 1, h)
            img[y0:y1, x0:x1] = rng.integers(0, 256, 3)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "PNG")
        out.append(buf.getvalue())
    return out


ENRICO_IGNORED = ("50105", "50109")


def build_enrico_tree(root: str, n: int, n_classes: int = 20,
                      size: Tuple[int, int] = (128, 256), quality: int = 90,
                      distinct: int = 16, seed: int = 0) -> Dict:
    """``design_topics.csv`` with ``n`` screens over ``n_classes`` topics
    (cycled) plus the two ignored ids, each with a screenshot JPEG and a
    wireframe PNG of ``size`` = (width, height)."""
    for sub in ("screenshots", "wireframes"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    jpegs = jpeg_pool(seed, distinct, size, quality)
    pngs = png_pool(seed + 1, distinct, size)
    ids = [str(10000 + 7 * i) for i in range(n)] + list(ENRICO_IGNORED)
    rows, nbytes = [], 0
    for i, sid in enumerate(ids):
        rows.append(f"{sid},topic_{i % n_classes:02d}\n")
        nbytes += _write(os.path.join(root, "screenshots", sid + ".jpg"),
                         jpegs[i % distinct])
        nbytes += _write(os.path.join(root, "wireframes", sid + ".png"),
                         pngs[(3 * i) % distinct])
    with open(os.path.join(root, "design_topics.csv"), "w") as f:
        f.writelines(["screen_id,topic\n", *rows])
    return {"screens": n, "bytes": nbytes}


_WORDS = ("the", "new", "photo", "of", "a", "cat", "shows", "mayor",
          "council", "breaking", "news", "fake", "real", "dog", "running",
          "unbelievable", "scientists", "discover", "city", "river")
WORDPIECE_VOCAB = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ".", ",",
                   "!", "?", "'", *_WORDS, "run", "##ning", "##s",
                   "scien", "##tist", "un", "##believ", "##able")


def _title(rng: np.random.Generator) -> str:
    words = [str(w) for w in rng.choice(_WORDS, rng.integers(0, 12))]
    if words and rng.random() < 0.5:
        words[0] = words[0].capitalize()
    if rng.random() < 0.5:
        words.append(str(rng.choice(["!", "?", ".", "Zebra's"])))
    return " ".join(words)


def build_fakenews_tree(root: str, n_train: int, n_val: int, n_test: int,
                        size: Tuple[int, int] = (96, 64), quality: int = 90,
                        embed_dim: int = 768, distinct: int = 16,
                        seed: int = 0) -> Dict:
    """The token variants' three TSVs (every seventh row without its
    image) with ``images/<id>.jpg`` of ``size`` = (width, height) and a
    WordPiece ``vocab.txt``, and the embed variants' dataframe pickles
    for both infixes over the same ids.  Labels cycle over the 6 ways."""
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rng = np.random.default_rng(seed)
    jpegs = jpeg_pool(seed, distinct, size, quality)
    nbytes, offset = 0, 0
    for tsv, split, count in (("train.tsv", "train", n_train),
                              ("validate.tsv", "val", n_val),
                              ("test.tsv", "test", n_test)):
        ids = [f"fn{offset + i:05d}" for i in range(count)]
        labels = [(offset + i) % 6 for i in range(count)]
        offset += count
        lines = ["id\tclean_title\t6_way_label\n"]
        for i, (sid, label) in enumerate(zip(ids, labels)):
            lines.append(f"{sid}\t{_title(rng)}\t{label}\n")
            if i % 7 != 3:
                nbytes += _write(os.path.join(root, "images", sid + ".jpg"),
                                 jpegs[(offset + i) % distinct])
        with open(os.path.join(root, tsv), "w") as f:
            f.writelines(lines)
        frame = {"id": ids, "label": np.asarray(labels, np.int64),
                 "embedding": rng.normal(size=(count, embed_dim)).astype(
                     np.float32)}
        for infix in ("text_image", "text_image_dialogue"):
            if infix == "text_image_dialogue":
                frame = dict(frame, dialogue_embedding=rng.normal(
                    size=(count, embed_dim)).astype(np.float32))
            nbytes += _write(os.path.join(
                root, f"{split}__{infix}_dataframe.pkl"), pickle.dumps(frame))
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.writelines(w + "\n" for w in WORDPIECE_VOCAB)
    return {"rows": offset, "bytes": nbytes}
