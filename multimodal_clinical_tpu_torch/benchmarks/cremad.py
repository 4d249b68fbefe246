"""Crema-D: audio log-spectrogram + 3 video frames, 6-way emotion
classification (port of ``multimodal_clinical_tpu/benchmarks/cremad.py``).

All ten model variants of the reference factory (cremad/__init__.py:4-23):
jlogits / jprobas / ensemble (CE x3, cremad/ensemble_model.py:54-55) /
ogm_ge (alpha from the config) / ensemble_ogm_ge (ensemble + modulation,
ensemble_model_noised.py:118-123) / qmf / qmf_ablate / qmf_ablate_Ljoint /
qmf_ablate_Lunimodal / ogm_ge_lreg (QMF loss + OGM-GE modulation,
joint_model_ogm_ge_lreg.py).

Data (reference cremad/get_data.py): ``train.csv`` / ``test.csv`` list the
clips; pickled (257, 1004) spectrograms under ``audio_spec/``; the first 3
JPEG frames of ``image/<clip>/`` through the reference's transforms (train
RandomResizedCrop(224) + flip, eval Resize((224, 224)), get_data.py:94-109),
shipped as uint8 and normalised on the card; balanced samplers on train
and val; val is the test set (get_data.py:160-166).  Without
``audio_spec/`` (one mode per corpus) the host ships the tiled 10 s
waveform from ``audio/<clip>.wav`` or, through libav, from
``video/<clip>.mp4|.flv``, and the spectrogram runs on the card
(``ops/spectrogram.py::cremad_spectrogram``, the math tools/preprocess.py
cremad-audio pickles); without ``image/<clip>/`` the first 3 ticks of the
1 FPS grid stream from the container.  Without ``train.csv`` under
``data_path`` the synthetic twin (64/32/32 rows) stands in.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import pickle
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..data.core import sample_rng
from ..data.imageops import (load_frame_eval_u8, load_frame_train_u8,
                             normalize_frames_device,
                             transform_frame_eval_u8,
                             transform_frame_train_u8)
from ..data.synthetic import make_synthetic_splits
from ..engine.run import DataBundle
from ..engine.spec import ModelSpec, resolve_dtype
from ..models.zoo import CremadFusionNet
from ..ops.spectrogram import cremad_spectrogram
from ..utils import avdecode
from ..utils.native import resample_linear
from .vggsound import _read_wav

MODEL_TYPES = ("jlogits", "jprobas", "ensemble", "ogm_ge", "ensemble_ogm_ge",
               "qmf", "qmf_ablate", "qmf_ablate_Ljoint",
               "qmf_ablate_Lunimodal", "ogm_ge_lreg")

SR = 16000
TILE_SEC = 10  # the tile-to->=10 s window (cremad/video_preprocessing.py:113-118)
_VIDEO_EXTS = (".mp4", ".mov", ".flv")  # raw Crema-D ships VideoFlash .flv


def _find_video(data_dir: str, clip_id: str, video_dir: str = "video"):
    for ext in _VIDEO_EXTS:
        path = os.path.join(data_dir, video_dir, clip_id + ext)
        if os.path.exists(path):
            return path
    return None


def _tile_clip_waveform(wav: np.ndarray, clip_id: str) -> np.ndarray:
    """Tile to the 10 s window and clip to [-1, 1]: the host half of the
    offline pipeline (video_preprocessing.py:113-118); the spectrogram
    half runs on the card (``device_preprocess``)."""
    if len(wav) == 0:
        raise ValueError(f"clip {clip_id!r}: decoded audio is empty")
    target = SR * TILE_SEC
    reps = int(np.ceil(target / len(wav)))
    return np.clip(np.tile(wav, reps)[:target], -1.0, 1.0).astype(np.float32)


class CremadDiskDataset:
    """Pickled spectrograms (or waveforms) and JPEG frames, read a batch
    at a time.

    The first ``num_frames`` frames of each clip's dir (the reference reads
    os.listdir order; sorted here, for a fixed order) through the
    reference's transforms.  The layout lives in class attributes, so AVE
    serves its own directory names from a subclass
    (``Audio-1004-SE``/``Image-01-FPS-SE``/``AVE``/``Audios``,
    ave/get_data.py:66-95).  The frames' draws come from the per-(seed,
    epoch, index) Generator, so a gather keeps no state and may run on any
    thread.
    """

    num_frames = 3  # PMR protocol (cremad/get_data.py:117)
    audio_pkl_dir = "audio_spec"
    image_dir = "image"
    video_dir = "video"
    wav_dir = "audio"

    def __init__(self, data_dir: str, items, train: bool, seed: int = 0,
                 audio_mode: str = "pkl"):
        self.data_dir = data_dir
        self.items = items  # list of (clip_id, label)
        self.train = train
        self.audio_mode = audio_mode  # "pkl" | "stream", one per corpus
        self.labels = np.asarray([lab for _, lab in items], np.int32)
        self._seed = int(seed)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __len__(self):
        return len(self.items)

    def _frame_names(self, frame_dir):
        return sorted(os.listdir(frame_dir))[: self.num_frames]

    def _find_video(self, clip_id: str):
        return _find_video(self.data_dir, clip_id, self.video_dir)

    def _stream_ticks(self, clip_id: str):
        """(start, end) seconds of the 1 FPS grid frames stream from:
        Crema-D reads from the clip's head (the reference picks the first
        3 extracted files, get_data.py:117); end None stops after
        ``num_frames`` ticks."""
        return 0.0, None

    def _stream_fps(self, clip_id: str) -> float:
        """The tick rate of frames streamed from a container: the
        extraction's 1 FPS (AVE raises it for short segments)."""
        return 1.0

    def _window_waveform(self, wav: np.ndarray, clip_id: str) -> np.ndarray:
        """The 10 s training window of a 16 kHz waveform: Crema-D tiles
        the whole clip (video_preprocessing.py:113-118)."""
        return _tile_clip_waveform(wav, clip_id)

    def _load_frames(self, clip_id: str, rng) -> np.ndarray:
        frame_dir = os.path.join(self.data_dir, self.image_dir, clip_id)
        if os.path.isdir(frame_dir):
            paths = [os.path.join(frame_dir, name)
                     for name in self._frame_names(frame_dir)]
            frames = [load_frame_train_u8(p, rng) if self.train
                      else load_frame_eval_u8(p) for p in paths]
        else:
            frames = self._stream_frames(clip_id, rng)
        if not frames:
            # admission checks the audio only: name the clip here, not in
            # an IndexError in a loader thread
            raise FileNotFoundError(
                f"clip {clip_id!r}: no frames under {frame_dir!r} and no "
                f"streamable {self.video_dir}/{clip_id}.mp4|.flv "
                f"(frame extraction incomplete?)")
        while len(frames) < self.num_frames:
            frames.append(frames[-1])
        return np.stack(frames)  # (num_frames, 224, 224, 3) uint8

    def _stream_frames(self, clip_id: str, rng):
        """No ``image/<clip>/`` dir: libav decodes the first
        ``num_frames`` ticks of the 1 FPS grid from the container (the
        frames the extraction would have written and get_data.py:117
        picked), and stops there."""
        path = self._find_video(clip_id)
        if path is None or not avdecode.available():
            return []
        start, end = self._stream_ticks(clip_id)
        fps = self._stream_fps(clip_id)
        frames = []
        for frame, _tick in avdecode.decode_frames_at_fps(path, fps,
                                                          start=start,
                                                          end=end):
            frames.append(transform_frame_train_u8(frame, rng) if self.train
                          else transform_frame_eval_u8(frame))
            if len(frames) == self.num_frames:
                break
        return frames

    def _load_audio_waveform(self, clip_id: str) -> np.ndarray:
        """Stream mode: 16 kHz mono from ``<wav_dir>/<clip>.wav``, else any
        codec straight from the container through libav; the benchmark's
        ``_window_waveform`` cuts the 10 s window."""
        wav_path = os.path.join(self.data_dir, self.wav_dir,
                                clip_id + ".wav")
        if os.path.exists(wav_path):
            return self._window_waveform(_read_wav(wav_path), clip_id)
        path = self._find_video(clip_id)
        if path is None:
            raise FileNotFoundError(
                f"clip {clip_id!r}: no {self.audio_pkl_dir} pickle, no "
                f"{self.wav_dir}/{clip_id}.wav, no video container")
        audio, sr = avdecode.read_audio_mono(path)
        return self._window_waveform(resample_linear(audio, sr, SR),
                                     clip_id)

    def gather(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        specs, frames, labels = [], [], []
        for i in indices:
            clip_id, label = self.items[int(i)]
            if self.audio_mode == "pkl":
                # the corpus' own pickles, written by the offline stage
                with open(os.path.join(self.data_dir, self.audio_pkl_dir,
                                       clip_id + ".pkl"), "rb") as f:
                    spec = pickle.load(f)
                specs.append(np.asarray(spec, np.float32)[..., None])
            else:  # "stream": the waveform, its spectrogram on the card
                specs.append(self._load_audio_waveform(clip_id))
            frames.append(self._load_frames(
                clip_id, sample_rng(self._seed, self._epoch, int(i))))
            labels.append(label)
        key = "x1" if self.audio_mode == "pkl" else "x1_waveform"
        return {
            key: np.stack(specs),
            "x2": np.stack(frames),  # uint8, normalised on the card
            "label": np.asarray(labels, np.int32),
        }


_CLASSES = {"NEU": 0, "HAP": 1, "SAD": 2, "FEA": 3, "DIS": 4, "ANG": 5}


def _audio_mode(data_dir: str) -> str:
    """'pkl' where the offline ``audio_spec/`` stage ran (the reference's
    layout, clips filtered by their pickle as in cremad/get_data.py:80-85),
    else 'stream'.  One mode per corpus, so every batch has the same
    keys."""
    if os.path.isdir(os.path.join(data_dir, "audio_spec")):
        return "pkl"
    print("[cremad] no audio_spec/ pickles — shipping 10 s waveforms and "
          "computing the (257, 1004) log-spectrogram on device "
          "(tools/preprocess.py cremad-audio builds the offline pickles)")
    return "stream"


class _StreamProbe:
    """A verdict per clip on streaming from its container, memoised per
    codec.

    Each clip's container is asked on its own: a header-only
    ``avdecode.probe`` reads its codec names, and whether libav has a
    decoder is looked up once per codec.  A mixed corpus (H.264 beside
    HEVC on a libav without HEVC) then admits exactly the clips that
    decode, and a damaged file rules out only itself.  ``dataset_cls``
    gives the layout (Crema-D's; AVE passes ``AveDiskDataset``)."""

    def __init__(self, data_dir: str, dataset_cls=None):
        self.data_dir = data_dir
        self.cls = dataset_cls or CremadDiskDataset
        self._by_codec: Dict[str, bool] = {}

    def _codec_ok(self, name: Optional[str]) -> bool:
        if not name:
            return False
        if name not in self._by_codec:
            self._by_codec[name] = avdecode.has_decoder(name)
        return self._by_codec[name]

    def _probe(self, sample_path: str) -> Tuple[bool, bool]:
        if not avdecode.available():
            return (False, False)
        info = avdecode.probe(sample_path)
        if info is None:  # the header does not parse: try to decode
            return (avdecode.can_decode_stream(sample_path, "audio"),
                    avdecode.can_decode_stream(sample_path, "video"))
        return (self._codec_ok(info.get("audio_codec")),
                self._codec_ok(info.get("video_codec")))

    def admissible(self, clip_id: str) -> bool:
        """Both modalities must be reachable, so that a gather cannot
        fail: audio from a wav or a decodable container track, frames from
        an extracted dir or a decodable video stream."""
        video = _find_video(self.data_dir, clip_id, self.cls.video_dir)
        audio_ok, video_ok = self._probe(video) if video else (False, False)
        has_wav = os.path.exists(
            os.path.join(self.data_dir, self.cls.wav_dir, clip_id + ".wav"))
        if not (has_wav or (video and audio_ok)):
            return False
        has_frames = os.path.isdir(
            os.path.join(self.data_dir, self.cls.image_dir, clip_id))
        return has_frames or bool(video and video_ok)

    def streamable_frames(self, clip_id: str) -> bool:
        """True where the clip's container has a decodable video stream
        (pkl-mode admission of a clip without a frame dir)."""
        video = _find_video(self.data_dir, clip_id, self.cls.video_dir)
        if not video:
            return False
        return self._probe(video)[1]


def _read_split(data_dir: str, csv_name: str, audio_mode: str = "pkl",
                stream_probe=None):
    items = []
    with open(os.path.join(data_dir, csv_name)) as f:
        for row in csv.reader(f):
            if not row:
                continue
            clip_id, cls = row[0], row[1]
            if cls not in _CLASSES:
                continue
            if audio_mode == "pkl":
                ok = os.path.exists(os.path.join(data_dir, "audio_spec",
                                                 clip_id + ".pkl"))
            else:
                ok = stream_probe.admissible(clip_id)
            if ok:
                items.append((clip_id, _CLASSES[cls]))
    return items


def get_data(args) -> DataBundle:
    data_dir = getattr(args, "data_path", "data/cremad/")
    seed = int(getattr(args, "seed", 0))
    if os.path.exists(os.path.join(data_dir, "train.csv")):
        mode = _audio_mode(data_dir)
        probe = _StreamProbe(data_dir) if mode == "stream" else None
        train_items = _read_split(data_dir, "train.csv", mode, probe)
        test_items = _read_split(data_dir, "test.csv", mode, probe)
        for name, split in (("train", train_items), ("test", test_items)):
            if not split:
                raise FileNotFoundError(
                    f"{data_dir}{name}.csv exists but 0 clips were "
                    "admitted: each clip needs audio_spec/<clip>.pkl "
                    "(tools/preprocess.py cremad-audio), or — for the "
                    "zero-offline-stage path — BOTH audio "
                    "(audio/<clip>.wav or a libav-decodable container "
                    "track) AND frames (image/<clip>/ dir or a "
                    "libav-decodable video stream in "
                    "video/<clip>.mp4|.flv)")
        train = CremadDiskDataset(data_dir, train_items, True, seed, mode)
        test = CremadDiskDataset(data_dir, test_items, False, seed, mode)
        # the reference's val is its test set (cremad/get_data.py:160-166)
        val, synthetic = test, False
    else:
        print(f"[cremad] real data not found under {data_dir!r}; "
              "using synthetic twin", flush=True)
        train, val, test = make_synthetic_splits(
            "cremad", int(args.num_classes), seed,
            n_train=64, n_val=32, n_test=32,
        )
        synthetic = True
    # balanced samplers on train and val, sequential test
    # (cremad/run_trainer.py:40-70)
    return DataBundle(train, val, test, train_sampler="weighted",
                      val_sampler="weighted", synthetic=synthetic)


def device_preprocess(batch: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator], train: bool):
    """uint8 frames -> ImageNet-normalised fp32 on the device (float frames
    pass); a waveform ``x1_waveform`` -> the (B, 257, T, 1) log-spectrogram
    (the math the offline cremad-audio stage pickles,
    video_preprocessing.py:119-130).  No augmentation: SpecAugment is
    dormant in cremad/get_data.py:17-48."""
    batch = dict(batch)
    batch["x2"] = normalize_frames_device(batch["x2"])
    if "x1_waveform" in batch:
        batch["x1"] = cremad_spectrogram(batch.pop("x1_waveform"))[..., None]
    return batch


def get_model_spec(args, n_train: int) -> Tuple[ModelSpec, Dict]:
    model_type = getattr(args, "model_type", "jlogits")
    module = CremadFusionNet(num_classes=int(args.num_classes),
                             dtype=resolve_dtype(args))
    alpha = float(getattr(args, "alpha", 0.8))
    grad_mod = getattr(args, "grad_mod_type", "OGM_GE")
    qmf = dict(contract="qmf", n_train_samples=n_train)

    if model_type == "jlogits":
        spec = ModelSpec(module=module, contract="jlogits")
    elif model_type == "jprobas":
        spec = ModelSpec(module=module, contract="jprobas")
    elif model_type == "ensemble":
        spec = ModelSpec(module=module, contract="ensemble",
                         unimodal_loss_scale=3.0)
    elif model_type == "ogm_ge":
        spec = ModelSpec(module=module, contract="ogm_ge",
                         grad_mod_type=grad_mod, ogm_alpha=alpha)
    elif model_type == "ensemble_ogm_ge":
        # plain CE (no x3.0, ensemble_model_noised.py:56-57), trained on
        # the MEAN (ensemble_model_noised.py:104)
        spec = ModelSpec(module=module, contract="ensemble",
                         ensemble_train_mean=True, apply_grad_mod=True,
                         grad_mod_type=grad_mod, ogm_alpha=alpha)
    elif model_type == "qmf":
        spec = ModelSpec(module=module, **qmf)
    elif model_type == "qmf_ablate":
        spec = ModelSpec(module=module, qmf_ablate_train=True, **qmf)
    elif model_type == "qmf_ablate_Ljoint":
        spec = ModelSpec(module=module, qmf_drop_joint=True, **qmf)
    elif model_type == "qmf_ablate_Lunimodal":
        spec = ModelSpec(module=module, qmf_drop_unimodal=True, **qmf)
    elif model_type == "ogm_ge_lreg":
        spec = ModelSpec(module=module, apply_grad_mod=True,
                         grad_mod_type=grad_mod, ogm_alpha=alpha, **qmf)
    else:
        raise NotImplementedError(f"cremad model_type {model_type!r}")
    return dataclasses.replace(spec, device_preprocess=device_preprocess), {}
