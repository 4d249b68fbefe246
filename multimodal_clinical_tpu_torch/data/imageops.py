"""On-device frame normalisation (port of the device half of
``multimodal_clinical_tpu/data/imageops.py``, ``:72-94``)."""

from __future__ import annotations

import torch

# ImageNet statistics (torchvision Normalize), kept here so the port needs
# nothing of the JAX package.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


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
