"""AVE: Audio-Visual Event, 28-way classification, PMR protocol (port of
``multimodal_clinical_tpu/benchmarks/ave.py``).

Scratch dual ResNet18 as Crema-D, with 6 distinct frames per clip
(ave/get_data.py:135), SpecAugment at train with reduced parameters
(ave/get_data.py:148-155) and the legacy StepLR(10, 0.5)
(ave/joint_model.py:250-258), under jlogits / jprobas / ensemble.

Data (reference ave/get_data.py): split lists ``trainSet.txt`` /
``valSet.txt`` / ``testSet.txt`` (``CLASS&clip&...``), class ids in
first-appearance order over ``testSet.txt`` (ave/get_data.py:79-87);
``Audio-1004-SE/<clip>.pkl`` (257, 1004) spectrograms and
``Image-01-FPS-SE/<clip>/`` frame dirs (ave/get_data.py:66-95), cut by the
offline stage to each clip's ``Annotations.txt`` window
(ave/video_preprocessing.py:216-279).  Balanced samplers on train and val;
the test sampler is built but never passed to the test DataLoader
(ave/run_training.py:84-92), so test iteration is sequential.  Without
``Audio-1004-SE/`` the host ships the window's 10 s waveform (from
``Audios/<clip>.wav``, or decoded from ``AVE/<clip>.mp4`` by libav) and
the spectrogram runs on the card (the extractWav_SE pickle math,
ave/video_preprocessing.py:244-279); without a frame dir the window's
1 FPS ticks stream from the container (start..end inclusive,
ave/video_preprocessing.py:121-126).  Without ``testSet.txt`` under
``data_path`` the synthetic twin (64/32/32 rows) stands in.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..data.imageops import normalize_frames_device
from ..data.synthetic import make_synthetic_splits
from ..engine.run import DataBundle
from ..engine.spec import ModelSpec, resolve_dtype
from ..models.zoo import CremadFusionNet
from ..ops.specaugment import apply_masks, spec_augment_masks
from ..ops.spectrogram import cremad_spectrogram
from .cremad import SR, TILE_SEC, CremadDiskDataset, _StreamProbe

MODEL_TYPES = ("jlogits", "jprobas", "ensemble")
NUM_FRAMES = 6
# the reduced masks of ave/get_data.py:148-155
SPEC_AUGMENT = dict(freq_mask_param=15, time_mask_param=60,
                    num_freq_masks=1, num_time_masks=1)
# video2frame_update_SE's defaults for a clip without an annotation row
# (ave/video_preprocessing.py:216)
DEFAULT_SEGMENT = (0, 10)


class AveDiskDataset(CremadDiskDataset):
    """Crema-D's dataset over the reference's AVE layout
    (ave/get_data.py:66-95), with 6 distinct frames per clip (PMR
    protocol, ave/get_data.py:135); stream mode follows each clip's
    ``Annotations.txt`` window."""

    num_frames = NUM_FRAMES
    audio_pkl_dir = "Audio-1004-SE"
    image_dir = "Image-01-FPS-SE"
    video_dir = "AVE"
    wav_dir = "Audios"

    def __init__(self, data_dir: str, items, train: bool, seed: int = 0,
                 audio_mode: str = "pkl",
                 segments: Optional[Dict[str, Tuple[int, int]]] = None):
        super().__init__(data_dir, items, train, seed, audio_mode)
        self.segments = segments or {}

    def _segment(self, clip_id: str) -> Tuple[int, int]:
        return self.segments.get(clip_id, DEFAULT_SEGMENT)

    def _stream_ticks(self, clip_id: str):
        # frames are saved for 1 FPS ticks with num_count in
        # [start_t, end_t], both ends included
        # (ave/video_preprocessing.py:121-126)
        start, end = self._segment(clip_id)
        return float(start), float(end) + 1.0

    def _stream_fps(self, clip_id: str) -> float:
        """A short segment streams at a raised tick rate, so that it still
        gives ``num_frames`` distinct frames: the reference's extraction
        tops short segments up to >= 10 distinct frames with random frame
        ids inside the window (ave/video_preprocessing.py:131-158); evenly
        spaced ticks are the deterministic stand-in (PARITY.md)."""
        start, end = self._stream_ticks(clip_id)
        window = max(end - start, 1e-6)
        if window >= self.num_frames:
            return 1.0
        return float(self.num_frames) / window

    def _window_waveform(self, wav: np.ndarray, clip_id: str) -> np.ndarray:
        """extractWav_SE's host math (ave/video_preprocessing.py:254-266):
        slice [start, end) seconds, tile x10, tile x10 again if still
        short, truncate to 10 s, clip to [-1, 1].

        A slice under 0.1 s goes on tiling up to the 10 s: the reference
        would pickle a short spectrogram there, which its own DataLoader
        then fails to stack."""
        start, end = self._segment(clip_id)
        seg = wav[SR * start: SR * end]
        if len(seg) == 0:
            raise ValueError(
                f"clip {clip_id!r}: empty audio segment [{start}, {end}) s "
                f"over a {len(wav) / SR:.2f} s waveform (Annotations.txt "
                "row wrong, or a truncated download whose audio ends "
                "before the annotated window?)")
        target = SR * TILE_SEC
        res = np.tile(seg, 10)
        if len(res) < target:
            res = np.tile(res, 10)
        if len(res) < target:  # a slice under 0.1 s; see the docstring
            res = np.tile(res, -(-target // len(res)))
        return np.clip(res[:target], -1.0, 1.0).astype(np.float32)


def _read_annotations(data_dir: str) -> Dict[str, Tuple[int, int]]:
    """clip -> (start_t, end_t) from ``Annotations.txt``
    (``category&clip&quality&start&end``, after a header line;
    ave/video_preprocessing.py:186-216)."""
    path = os.path.join(data_dir, "Annotations.txt")
    segments: Dict[str, Tuple[int, int]] = {}
    if not os.path.exists(path):
        return segments
    with open(path) as f:
        lines = f.readlines()
    for line in lines[1:]:
        parts = line.strip().split("&")
        if len(parts) >= 5:
            try:
                segments[parts[1]] = (int(parts[3]), int(parts[4]))
            except ValueError:
                continue
    return segments


def _audio_mode(data_dir: str) -> str:
    """'pkl' where the offline ``Audio-1004-SE/`` stage ran (the
    reference's layout), else 'stream' (the windowed waveforms, their
    spectrogram on the card)."""
    if os.path.isdir(os.path.join(data_dir, AveDiskDataset.audio_pkl_dir)):
        return "pkl"
    print("[ave] no Audio-1004-SE/ pickles — shipping SE-windowed 10 s "
          "waveforms and computing the (257, 1004) log-spectrogram on "
          "device (ave/video_preprocessing.py extractWav_SE equivalent)")
    return "stream"


def _read_split_txt(data_dir: str, txt: str, class_map, audio_mode: str,
                    probe: _StreamProbe,
                    segments: Optional[Dict[str, Tuple[int, int]]] = None):
    """A split's clips under the reference's admission
    (ave/get_data.py:89-101): unknown classes skipped, a clip admitted
    once, both modalities reachable (pkl mode: the pickle, and extracted
    frames or a streamable video; stream mode: both from wavs or
    containers).  Stream mode drops, with a note, a clip whose
    ``Annotations.txt`` window is empty (start >= end; the reference's
    own FIXME, ave/video_preprocessing.py:145): its gather would raise in
    a loader thread."""
    items, seen = [], set()
    path = os.path.join(data_dir, txt)
    if not os.path.exists(path):
        return items
    with open(path) as f:
        for line in f:
            parts = line.strip().split("&")
            if len(parts) < 2 or parts[0] not in class_map:
                continue
            clip = parts[1]
            if clip in seen:
                continue
            if audio_mode == "pkl":
                ok = os.path.exists(
                    os.path.join(data_dir, AveDiskDataset.audio_pkl_dir,
                                 clip + ".pkl"))
                ok = ok and (
                    os.path.isdir(os.path.join(
                        data_dir, AveDiskDataset.image_dir, clip))
                    or probe.streamable_frames(clip))
            else:
                start, end = (segments or {}).get(clip, DEFAULT_SEGMENT)
                if start >= end:
                    print(f"[ave] dropping {clip!r}: empty Annotations.txt "
                          f"segment [{start}, {end})")
                    continue
                ok = probe.admissible(clip)
            if ok:
                seen.add(clip)
                items.append((clip, class_map[parts[0]]))
    return items


def _disk_splits(args, data_dir: str, test_txt: str):
    """(train, val, test) disk datasets from the three split lists."""
    # class ids in first-appearance order over testSet.txt: the reference
    # appends unseen classes in file order (ave/get_data.py:79-87)
    classes = []
    with open(test_txt) as f:
        for line in f:
            if "&" not in line:
                continue
            cls = line.split("&")[0]
            if cls not in classes:
                classes.append(cls)
    class_map = {c: i for i, c in enumerate(classes)}
    seed = int(getattr(args, "seed", 0))
    mode = _audio_mode(data_dir)
    segments = _read_annotations(data_dir)
    probe = _StreamProbe(data_dir, AveDiskDataset)
    splits = []
    for txt, train in (("trainSet.txt", True), ("valSet.txt", False),
                       ("testSet.txt", False)):
        items = _read_split_txt(data_dir, txt, class_map, mode, probe,
                                segments)
        if not items:
            raise FileNotFoundError(
                f"{data_dir}{txt}: 0 clips admitted — each clip needs "
                "Audio-1004-SE/<clip>.pkl + Image-01-FPS-SE/<clip>/ "
                "(the offline SE extraction), or — for the "
                "zero-offline-stage path — AVE/<clip>.mp4 with "
                "libav-decodable audio AND video streams (or "
                "Audios/<clip>.wav for the audio half)")
        splits.append(AveDiskDataset(data_dir, items, train, seed, mode,
                                     segments))
    return splits


def get_data(args) -> DataBundle:
    data_dir = getattr(args, "data_path", "data/ave/")
    test_txt = os.path.join(data_dir, "testSet.txt")
    if os.path.exists(test_txt):
        train, val, test = _disk_splits(args, data_dir, test_txt)
        synthetic = False
    else:
        print(f"[ave] real data not found under {data_dir!r}; "
              "using synthetic twin", flush=True)
        train, val, test = make_synthetic_splits(
            "ave", int(args.num_classes), int(getattr(args, "seed", 0)),
            n_train=64, n_val=32, n_test=32,
        )
        synthetic = True
    # balanced samplers on train and val; the test sampler is built but
    # never passed to the test DataLoader (ave/run_training.py:84-92)
    return DataBundle(train, val, test, train_sampler="weighted",
                      val_sampler="weighted", synthetic=synthetic)


def device_preprocess(batch: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator], train: bool):
    """uint8 frames -> ImageNet-normalised fp32 (float frames pass); a
    waveform ``x1_waveform`` -> the (B, 257, T, 1) log-spectrogram (the
    extractWav_SE pickle math, ave/video_preprocessing.py:268-276); at
    train, one frequency and one time mask drawn from the step's
    generator (ave/get_data.py:148-155)."""
    batch = dict(batch)
    batch["x2"] = normalize_frames_device(batch["x2"])
    if "x1_waveform" in batch:
        batch["x1"] = cremad_spectrogram(batch.pop("x1_waveform"))[..., None]
    if not train:
        return batch
    spec2d = batch["x1"][..., 0]
    b, f, t = spec2d.shape
    fmask, tmask = spec_augment_masks(generator, b, f, t, spec2d.device,
                                      **SPEC_AUGMENT)
    batch["x1"] = apply_masks(spec2d, fmask, tmask)[..., None]
    return batch


def get_model_spec(args, n_train: int) -> Tuple[ModelSpec, Dict]:
    model_type = getattr(args, "model_type", "jprobas")
    module = CremadFusionNet(num_classes=int(args.num_classes),
                             dtype=resolve_dtype(args))
    common = dict(sched_step_size=10, sched_gamma=0.5,
                  device_preprocess=device_preprocess,
                  # legacy runner: no ModelCheckpoint, test on the
                  # final-epoch weights (ave/run_training.py:106-131)
                  test_restore_best=False,
                  # flat epoch-end names (ave/joint_model.py:197-201)
                  legacy_metric_aliases=True)
    if model_type == "jlogits":
        spec = ModelSpec(module=module, contract="jlogits", **common)
    elif model_type == "jprobas":
        spec = ModelSpec(module=module, contract="jprobas", **common)
    elif model_type == "ensemble":
        # legacy dir: the train loss is the MEAN (ave/ensemble_model.py:115)
        spec = ModelSpec(module=module, contract="ensemble",
                         ensemble_train_mean=True, **common)
    else:
        raise NotImplementedError(f"ave model_type {model_type!r}")
    return spec, {}
