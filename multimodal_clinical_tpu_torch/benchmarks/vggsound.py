"""VGGSound: data, device preprocessing and model spec (port of
``multimodal_clinical_tpu/benchmarks/vggsound.py``), under jlogits /
jprobas / ensemble.

Data (reference vggsound/get_data.py): ``vggsound.csv`` lists the clips
(``ytid,start,class,split``); each is read on the fly in the loader's
threads: its 16 kHz mono audio tiled to >= 10 s and cropped to a random
5 s, and ``use_video_frames`` random frames of its 1 FPS JPEG grid under
``frames/<clip>/``.  The host ships the raw (B, 80000) float32 waveform
and uint8 frames; the log-STFT (the CUDA kernel), SpecAugment and the
ImageNet normalisation run on the card (``device_preprocess``).  Audio
comes from ``audio/<clip>.wav``, or straight from ``video/<clip>.mp4``
(the native demuxer for PCM, libav for compressed tracks); frames from
the JPEG grid, or decoded from the container by libav.  Without
``vggsound.csv`` under ``data_path`` the synthetic twin (64/32/32 rows,
the spectrogram ``x1`` and four frames of ``x2``) stands in.
"""

from __future__ import annotations

import csv
import os
import wave
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
from ..ops.cuda_spectrogram import log_spectrogram
from ..ops.specaugment import apply_masks, spec_augment_masks
from ..utils import avdecode
from ..utils.native import (Mp4File, mp4_pcm_undecodable_reason,
                            pcm16_to_float_mono, read_mp4_pcm_mono,
                            resample_linear)

MODEL_TYPES = ("jlogits", "jprobas", "ensemble")
SR = 16000
CROP_SEC = 5
N_FFT = 256
HOP = 128
# torchaudio masks of vggsound/get_data.py:18-45
SPEC_AUGMENT = dict(freq_mask_param=30, time_mask_param=120,
                    num_freq_masks=2, num_time_masks=3)
_VIDEO_EXTS = (".mp4", ".mov")
#: the 1 FPS tick grid frames stream from a container on: the grid
#: tools/preprocess.py video-frames extracts (and the reference's
#: vggsound/video_preprocessing.py dumps)
FRAME_FPS = 1.0


def _read_wav(path: str) -> np.ndarray:
    """A 16-bit PCM wav as float32 mono in [-1, 1] at SR: the native
    mixdown where the library loads, numpy's otherwise; a wav at another
    rate is resampled linearly (the reference's librosa.load(sr=16000)
    resamples too, vggsound/get_data.py:106)."""
    with wave.open(path, "rb") as w:
        n = w.getnframes()
        channels = w.getnchannels()
        rate = w.getframerate()
        data = np.frombuffer(w.readframes(n), dtype=np.int16)
    out = pcm16_to_float_mono(data, channels)
    if out is None:
        if channels > 1:
            data = data.reshape(-1, channels).mean(axis=1)
        out = (data / 32768.0).astype(np.float32)
    if rate != SR:
        out = resample_linear(out, rate, SR)
    return out


def _read_audio(data_dir: str, clip_id: str) -> np.ndarray:
    """A clip's audio at 16 kHz float mono: ``audio/<clip>.wav`` where the
    wav extraction ran, else straight from ``video/<clip>.mp4|.mov``: a
    PCM track through the native demuxer, any other through libav."""
    wav_path = os.path.join(data_dir, "audio", clip_id + ".wav")
    if os.path.exists(wav_path):
        return _read_wav(wav_path)
    for ext in _VIDEO_EXTS:
        path = os.path.join(data_dir, "video", clip_id + ext)
        if os.path.exists(path):
            try:
                audio, sr = read_mp4_pcm_mono(path)
            except Exception:
                # any failure of the native path (a compressed codec, the
                # library not loading, a short read of a truncated file):
                # libav is the catch-all, as _mp4_streamable's probe
                # admits; re-raise only where it does not load either
                if not avdecode.available():
                    raise
                audio, sr = avdecode.read_audio_mono(path)
            return resample_linear(audio, sr, SR)
    raise FileNotFoundError(
        f"no audio for {clip_id}: neither audio/{clip_id}.wav nor "
        f"video/{clip_id}.mp4 under {data_dir}")


def _mp4_streamable(data_dir: str) -> bool:
    """Can clips stream their audio straight from the container?  Asked
    of the first ``video/*.mp4|.mov`` (a corpus is of one codec): True
    where the native PCM path decodes it or libav has its decoder, so a
    clip without a wav is admitted only where its gather cannot fail."""
    video_dir = os.path.join(data_dir, "video")
    if not os.path.isdir(video_dir):
        return False
    for name in sorted(os.listdir(video_dir)):
        if not name.endswith(_VIDEO_EXTS):
            continue
        path = os.path.join(video_dir, name)
        try:
            with Mp4File(path) as m:
                audio = [t for t in m.tracks if t["handler"] == "soun"]
        except Exception:
            audio = None  # not a container the demuxer reads: ask libav
        if audio:
            reason = mp4_pcm_undecodable_reason(audio[0])
            if reason is None:
                return True
        elif audio is not None:
            reason = "no audio track"
        else:
            reason = "container unreadable by the native demuxer"
        if avdecode.available():
            # the decoder resolved by codec id, as read_audio_mono will
            if avdecode.can_decode_stream(path, "audio"):
                return True
            info = avdecode.probe(path)
            codec = info["audio_codec"] if info else None
            reason = (f"audio codec {codec!r} has no libav decoder"
                      if codec else reason)
        print(f"[vggsound] video/{name}: {reason} — "
              "mp4-direct streaming disabled (extract wavs via "
              "tools/preprocess.py mp4-to-wav)")
        return False
    return False


def _mp4_frames_streamable(data_dir: str) -> bool:
    """Can clips without a ``frames/<clip>/`` dir stream their frames from
    the container?  True where libav loads and resolves a decoder for the
    first video file.  Streaming decodes the whole clip per sample, so it
    prints a note on the throughput."""
    video_dir = os.path.join(data_dir, "video")
    if not os.path.isdir(video_dir) or not avdecode.available():
        return False
    for name in sorted(os.listdir(video_dir)):
        if not name.endswith(_VIDEO_EXTS):
            continue
        path = os.path.join(video_dir, name)
        if avdecode.can_decode_stream(path, "video"):
            info = avdecode.probe(path)
            codec = (info or {}).get("video_codec", "?")
            print(f"[vggsound] streaming video frames straight from "
                  f"containers ({codec} via libav) for clips without an "
                  "extracted frames/<clip>/ dir — decode-per-sample is "
                  "slower than pre-extracted JPEGs; run tools/preprocess.py "
                  "video-frames for full throughput")
            return True
        return False
    return False


class VGGSoundDiskDataset:
    """The host side: a raw waveform crop and decoded frames per clip; the
    DSP runs on the card.  Every draw comes from the per-(seed, epoch,
    index) Generator, so a gather keeps no state and may run on any
    thread."""

    def __init__(self, data_dir: str, items, train: bool,
                 use_video_frames: int = 4, seed: int = 0):
        self.data_dir = data_dir
        self.items = items  # list of (clip_id, label)
        self.train = train
        self.use_video_frames = use_video_frames
        self.labels = np.asarray([l for _, l in items], np.int32)
        self._seed = int(seed)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __len__(self):
        return len(self.items)

    def gather(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        waves, frames, labels = [], [], []
        for i in indices:
            rng = sample_rng(self._seed, self._epoch, int(i))
            clip_id, label = self.items[int(i)]
            wav = _read_audio(self.data_dir, clip_id)
            if len(wav) == 0:
                # np.tile of an empty array stays empty: the loop below
                # would not end
                raise ValueError(
                    f"clip {clip_id!r}: decoded audio is empty "
                    f"(failed/truncated wav or PCM track)")
            while len(wav) < SR * 10:
                wav = np.tile(wav, 2)
            # a random 5 s crop in every mode: the reference draws
            # random.randint(0, rate*5) at eval and test too
            # (get_data.py:113), as it picks frames at random below
            start = rng.integers(0, SR * 5 + 1)
            waves.append(np.clip(wav[start:start + SR * CROP_SEC], -1.0,
                                 1.0))
            frame_dir = os.path.join(self.data_dir, "frames", clip_id)
            if os.path.isdir(frame_dir):
                names = sorted(os.listdir(frame_dir))
                # random frames in both modes (get_data.py:148-152)
                picks = np.sort(rng.choice(
                    len(names), self.use_video_frames,
                    replace=len(names) < self.use_video_frames))
                # train RandomResizedCrop + flip, eval Resize
                # (get_data.py:131-143), uint8: normalised on the card
                fs = [load_frame_train_u8(os.path.join(frame_dir, names[p]),
                                          rng) if self.train
                      else load_frame_eval_u8(os.path.join(frame_dir,
                                                           names[p]))
                      for p in picks]
            else:
                fs = self._stream_frames(clip_id, rng)
            frames.append(np.stack(fs))
            labels.append(label)
        return {
            # the raw waveform: the step maps it through the log-STFT
            "x1_waveform": np.stack(waves),
            "x2": np.stack(frames),
            "label": np.asarray(labels, np.int32),
        }

    def _stream_frames(self, clip_id: str, rng: np.random.Generator):
        """Frames of a clip without a ``frames/<clip>/`` dir: libav
        decodes the container's 1 FPS tick grid (the grid the extraction
        would have written), then the same random picks and transforms.
        Admission made sure libav decodes the corpus' codec, so a failure
        here is a damaged file, raised with the clip named."""
        for ext in _VIDEO_EXTS:
            path = os.path.join(self.data_dir, "video", clip_id + ext)
            if os.path.exists(path):
                break
        else:
            raise FileNotFoundError(
                f"no frames for {clip_id}: neither frames/{clip_id}/ nor "
                f"video/{clip_id}.mp4 under {self.data_dir}")
        decoded = [f for f, _ in avdecode.decode_frames_at_fps(path,
                                                               FRAME_FPS)]
        if not decoded:
            raise ValueError(
                f"clip {clip_id!r}: video decoded to zero frames")
        picks = np.sort(rng.choice(
            len(decoded), self.use_video_frames,
            replace=len(decoded) < self.use_video_frames))
        if self.train:
            return [transform_frame_train_u8(decoded[p], rng) for p in picks]
        return [transform_frame_eval_u8(decoded[p]) for p in picks]


def _read_csv_items(data_dir: str, csv_name: str, split: str,
                    class_map: dict, mp4_ok: bool = False,
                    frames_stream_ok=None):
    """The rows of one split through one class map shared by both splits,
    grown in train-row order (the reference maps both splits through the
    train split's dict, vggsound/get_data.py:88-101).

    A clip is admitted where its wav exists (the reference's rule), or,
    with ``mp4_ok`` (``_mp4_streamable``), where ``video/<clip>.mp4|.mov``
    exists and its frames can be had: a ``frames/<clip>/`` dir, or
    ``frames_stream_ok()``, called only for a clip without one.  Admission
    means its gather cannot fail."""
    items = []
    with open(os.path.join(data_dir, csv_name)) as f:
        for row in csv.reader(f):
            if len(row) < 4 or row[3] != split:
                continue
            # the start time zero-filled to 6 digits: the name every
            # producer writes (reference get_data.py:70-71, fix_missing.py
            # :17, tools/preprocess.py vggsound-split)
            clip_id, cls = f"{row[0]}_{str(row[1]).zfill(6)}", row[2]
            if split == "train":
                class_map.setdefault(cls, len(class_map))
            if cls not in class_map:
                continue
            ok = os.path.exists(os.path.join(data_dir, "audio",
                                             clip_id + ".wav"))
            if not ok and mp4_ok:
                ok = any(os.path.exists(os.path.join(
                    data_dir, "video", clip_id + ext))
                    for ext in _VIDEO_EXTS) and (
                        os.path.isdir(os.path.join(data_dir, "frames",
                                                   clip_id))
                        or (frames_stream_ok is not None
                            and frames_stream_ok()))
            if ok:
                items.append((clip_id, class_map[cls]))
    return items


def _disk_splits(args, data_dir: str):
    """(train, test) disk datasets from ``vggsound.csv``."""
    seed = int(getattr(args, "seed", 0))
    nframes = int(getattr(args, "use_video_frames", 4))
    class_map: dict = {}
    mp4_ok = _mp4_streamable(data_dir)
    # memoised: the probe (and its note) runs only if some admitted
    # candidate lacks a frames dir
    probed: list = []

    def frames_stream_ok() -> bool:
        if not probed:
            probed.append(_mp4_frames_streamable(data_dir))
        return probed[0]

    train_items = _read_csv_items(data_dir, "vggsound.csv", "train",
                                  class_map, mp4_ok, frames_stream_ok)
    test_items = _read_csv_items(data_dir, "vggsound.csv", "test",
                                 class_map, mp4_ok, frames_stream_ok)
    for split_name, split_items in (("train", train_items),
                                    ("test", test_items)):
        if not split_items:
            raise FileNotFoundError(
                f"{data_dir}vggsound.csv exists but 0 {split_name} "
                "clips were admitted: each clip needs "
                "audio/<clip>.wav (run tools/preprocess.py mp4-to-wav) "
                "or, for streamable-audio mp4s, video/<clip>.mp4 plus "
                "frames — an extracted frames/<clip>/ dir "
                "(tools/preprocess.py video-frames), or the libav "
                "module to stream them from the container")
    return (VGGSoundDiskDataset(data_dir, train_items, True, nframes, seed),
            VGGSoundDiskDataset(data_dir, test_items, False, nframes, seed))


def get_data(args) -> DataBundle:
    data_dir = getattr(args, "data_path", "data/vggsound/")
    if os.path.exists(os.path.join(data_dir, "vggsound.csv")):
        train, test = _disk_splits(args, data_dir)
        # the reference's val is its test set (vggsound/get_data.py:
        # 180-185)
        val, synthetic = test, False
    else:
        print(f"[vggsound] real data not found under {data_dir!r}; "
              "using synthetic twin", flush=True)
        train, val, test = make_synthetic_splits(
            "vggsound", int(args.num_classes), int(getattr(args, "seed", 0)),
            n_train=64, n_val=32, n_test=32,
        )
        synthetic = True
    # balanced samplers on train AND val (vggsound/run_training.py:62-80;
    # val aliases the test set there); test iteration is sequential
    return DataBundle(train, val, test, train_sampler="weighted",
                      val_sampler="weighted", synthetic=synthetic)


def device_preprocess(batch: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator], train: bool):
    """Raw waveform -> (B, 129, T, 1) log-spectrogram (+ SpecAugment at
    train) on the waveform's device (vggsound/get_data.py:106-128).  The
    spectrogram is the CUDA kernel for a CUDA tensor, its plain version for
    a CPU one; uint8 frames are ImageNet-normalised, float frames pass."""
    batch = dict(batch)
    batch["x2"] = normalize_frames_device(batch["x2"])
    if "x1_waveform" not in batch:
        return batch
    spec2d = log_spectrogram(batch.pop("x1_waveform"), n_fft=N_FFT, hop=HOP)
    if train:
        b, f, t = spec2d.shape
        fmask, tmask = spec_augment_masks(generator, b, f, t, spec2d.device,
                                          **SPEC_AUGMENT)
        spec2d = apply_masks(spec2d, fmask, tmask)
    batch["x1"] = spec2d[..., None]
    return batch


def get_model_spec(args, n_train: int) -> Tuple[ModelSpec, Dict]:
    model_type = getattr(args, "model_type", "jprobas")
    module = CremadFusionNet(num_classes=int(args.num_classes),
                             dtype=resolve_dtype(args))
    common = dict(sched_step_size=30, sched_gamma=0.5,
                  device_preprocess=device_preprocess,
                  # legacy runner: no ModelCheckpoint, test on the
                  # final-epoch weights (vggsound/run_training.py:106-130)
                  test_restore_best=False,
                  # flat epoch-end names (vggsound/ensemble_model.py:
                  # 171-174)
                  legacy_metric_aliases=True)
    if model_type == "jlogits":
        spec = ModelSpec(module=module, contract="jlogits", **common)
    elif model_type == "jprobas":
        spec = ModelSpec(module=module, contract="jprobas", **common)
    elif model_type == "ensemble":
        # legacy dir: the train loss is the MEAN
        # (vggsound/ensemble_model.py:114)
        spec = ModelSpec(module=module, contract="ensemble",
                         ensemble_train_mean=True, **common)
    else:
        raise NotImplementedError(f"vggsound model_type {model_type!r}")
    return spec, {}
