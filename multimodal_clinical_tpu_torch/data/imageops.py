"""Frame transforms (port of ``multimodal_clinical_tpu/data/imageops.py``):
the host half decodes and crops JPEG frames to uint8, the device half
normalises them on the card.

The reference's torchvision pipelines (cremad/get_data.py:94-109):
train RandomResizedCrop(224) + RandomHorizontalFlip + ImageNet normalise,
eval Resize((224, 224)) + ImageNet normalise.

The crop box follows torchvision's RandomResizedCrop search (scale (0.08,
1.0), log-uniform ratio (3/4, 4/3), 10 attempts, then the clamped centre
crop) on a caller-owned numpy Generator, so a loader's frames are the same
per seed.  A JPEG decodes through the native libjpeg path
(``utils/native.py``) where the library loads, else through PIL, chosen
per call as the JAX package chooses: the two paths are not bit-equal to
each other, and each equals the JAX package's same path.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..utils import native

# ImageNet statistics (torchvision Normalize), kept here so the port needs
# nothing of the JAX package.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_SCALE = (0.08, 1.0)
_RATIO = (3.0 / 4.0, 4.0 / 3.0)


def random_resized_crop_box(rng: np.random.Generator, width: int,
                            height: int,
                            scale: Tuple[float, float] = _SCALE,
                            ratio: Tuple[float, float] = _RATIO
                            ) -> Tuple[int, int, int, int]:
    """(left, top, right, bottom) pixel box, torchvision's semantics."""
    area = width * height
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            top = int(rng.integers(0, height - h + 1))
            left = int(rng.integers(0, width - w + 1))
            return left, top, left + w, top + h
    # fallback: centre crop at the nearest in-range aspect
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w, h = width, int(round(width / ratio[0]))
    elif in_ratio > ratio[1]:
        w, h = int(round(height * ratio[1])), height
    else:
        w, h = width, height
    left = (width - w) // 2
    top = (height - h) // 2
    return left, top, left + w, top + h


def _normalize(img01: np.ndarray) -> np.ndarray:
    return ((img01 - np.asarray(IMAGENET_MEAN, np.float32))
            / np.asarray(IMAGENET_STD, np.float32)).astype(np.float32)


def _quantize_u8(img01: np.ndarray) -> np.ndarray:
    """Float [0, 1] -> uint8 as PIL would hold it: the reference's
    torchvision pipeline reads a uint8 PIL image into ToTensor, so the
    resized data is 8-bit; the native decoder resamples in float, and the
    rounding here puts both paths in the same wire format."""
    return np.clip(np.rint(img01 * 255.0), 0, 255).astype(np.uint8)


def _pil_open(path: str):
    from PIL import Image

    return Image.open(path).convert("RGB")


def pil_resize_u8(path: str, width: int, height: int,
                  bilinear: bool = True) -> np.ndarray:
    """PIL decode to RGB and resize to (height, width, 3) uint8: BILINEAR
    (torchvision Resize's, Enrico's), or with ``bilinear=False`` PIL's own
    default resample (FakeNews's ``resize((224, 224))``)."""
    from PIL import Image

    img = _pil_open(path)
    if bilinear:
        img = img.resize((width, height), resample=Image.BILINEAR)
    else:
        img = img.resize((width, height))
    return np.asarray(img, np.uint8)


def load_frame_eval_u8(path: str, size: int = 224) -> np.ndarray:
    """Resize((size, size)) -> uint8 RGB, before normalisation (which runs
    on the card): the native decode with resize where the library loads,
    PIL bilinear otherwise."""
    try:
        decoded = native.decode_jpeg(path, size, size)
    except Exception:
        decoded = None
    if decoded is not None:
        return _quantize_u8(decoded)
    from PIL import Image

    img = _pil_open(path).resize((size, size), Image.BILINEAR)
    return np.asarray(img, np.uint8)


def load_frame_eval(path: str, size: int = 224) -> np.ndarray:
    """``load_frame_eval_u8`` with ToTensor and Normalize on the host."""
    return _normalize(load_frame_eval_u8(path, size).astype(np.float32)
                      / 255.0)


def load_frame_train_u8(path: str, rng: np.random.Generator,
                        size: int = 224) -> np.ndarray:
    """RandomResizedCrop(size) + horizontal flip (p = 0.5) -> uint8 RGB,
    before normalisation.

    The native crop path reads the file once for the header's dims and the
    libjpeg crop-and-resize; PIL's box resize otherwise.  The crop box is
    drawn against the native dims, or PIL's where the probe failed, then
    the flip: the same draws on both paths."""
    data = None
    dims = None
    try:
        with open(path, "rb") as f:
            data = f.read()
        dims = native.jpeg_dims(data)
    except Exception:
        dims = None
    out = None
    box = None
    if dims is not None:
        height, width = dims
        box = random_resized_crop_box(rng, width, height)
        out = native.decode_jpeg_crop(data, box, size, size)
    if out is not None:
        out = _quantize_u8(out)
    else:
        from PIL import Image

        img = _pil_open(path)
        if box is None:  # the dims probe failed: draw against PIL's dims
            box = random_resized_crop_box(rng, img.width, img.height)
        img = img.resize((size, size), Image.BILINEAR, box=box)
        out = np.asarray(img, np.uint8)
    if rng.random() < 0.5:
        out = out[:, ::-1]
    return out


def load_frame_train(path: str, rng: np.random.Generator,
                     size: int = 224) -> np.ndarray:
    """``load_frame_train_u8`` with ToTensor and Normalize on the host."""
    return _normalize(load_frame_train_u8(path, rng, size)
                      .astype(np.float32) / 255.0)


def transform_frame_train_u8(img: np.ndarray, rng: np.random.Generator,
                             size: int = 224) -> np.ndarray:
    """RandomResizedCrop(size) + horizontal flip of a decoded uint8 RGB
    array (frames streamed from a container by libav); the draws of
    ``load_frame_train_u8`` in its order: the crop box, then the flip."""
    from PIL import Image

    pil = Image.fromarray(img)
    box = random_resized_crop_box(rng, pil.width, pil.height)
    out = np.asarray(pil.resize((size, size), Image.BILINEAR, box=box),
                     np.uint8)
    if rng.random() < 0.5:
        out = out[:, ::-1]
    return out


def transform_frame_eval_u8(img: np.ndarray, size: int = 224) -> np.ndarray:
    """Resize((size, size)) of a decoded uint8 RGB array: the eval twin of
    ``transform_frame_train_u8``."""
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize((size, size),
                                                  Image.BILINEAR), np.uint8)


def normalize_frames_device(frames: torch.Tensor) -> torch.Tensor:
    """uint8 (..., 3) -> float32 ImageNet-normalised, on the tensor's
    device.  A float input passes through unchanged (synthetic twins and
    the bench fixture ship float frames)."""
    if frames.dtype != torch.uint8:
        return frames
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=frames.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                       device=frames.device)
    return (frames.to(torch.float32) / 255.0 - mean) / std


def to_unit_floats_device(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0, 1] without normalisation; float inputs pass
    through unchanged."""
    if x.dtype != torch.uint8:
        return x
    return x.to(torch.float32) / 255.0
