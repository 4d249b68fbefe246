"""The VGGSound train-step fixture (port of
``multimodal_clinical_tpu/benchmarks/vggsound_fixture.py``).

Geometry: the reference's published VGGSound configuration — batch 224,
309 classes, dual scratch ResNet18 in bf16, jprobas contract, on-device
STFT and SpecAugment (vggsound/README.md:5-6, vggsound/vggsound.yaml).
Inputs come from numpy's seed-0 generator in the JAX fixture's order, so
both packages see the same waveform, frames and labels.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..engine.spec import ModelSpec
from ..engine.state import create_train_state
from ..engine.steps import make_train_step
from ..models.zoo import CremadFusionNet
from ..utils.device import resolve_device
from .vggsound import device_preprocess


def build_vggsound_bench(batch: int = 224, num_classes: int = 309, *,
                         pool_kernel: str = "xla",
                         stem_space_to_depth: bool = False,
                         remat: Optional[str] = None, device="cuda",
                         frames_bf16: bool = True,
                         num_frames: int = 4, image_size: int = 224,
                         samples: int = 80000, width: int = 64,
                         dtype: Optional[torch.dtype] = torch.bfloat16):
    """(train_step, state, device_batch, spec) for the train step at the
    reference geometry (``make_eval_step(spec)`` evaluates it).  The keyword
    sizes default to the reference geometry; the tests and the card-against-
    CPU check shrink them and compute in fp32.  ``frames_bf16`` mirrors the
    production loader's transfer cast; ``pool_kernel="pallas"`` is the
    towers' stored-index max-pool, ``stem_space_to_depth`` their
    space-to-depth stem and ``remat`` their block recompute (see
    ``models/resnet.py``)."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    wave = rng.normal(scale=0.1, size=(batch, samples)).astype(np.float32)
    frames = rng.normal(size=(batch, num_frames, image_size, image_size, 3)
                        ).astype(np.float32)
    label = rng.integers(0, num_classes, size=batch).astype(np.int64)
    args = SimpleNamespace(num_classes=num_classes, batch_size=batch,
                           learning_rate=1e-2, num_epochs=60,
                           use_scheduler=False, seed=0)
    spec = ModelSpec(
        module=CremadFusionNet(num_classes, dtype=dtype, width=width,
                               pool_kernel=pool_kernel, remat=remat,
                               stem_space_to_depth=stem_space_to_depth),
        contract="jprobas",
        device_preprocess=device_preprocess,
    )
    state = create_train_state(spec, args, seed=0, steps_per_epoch=100,
                               device=device)
    x2 = torch.from_numpy(frames)
    if frames_bf16:
        x2 = x2.to(torch.bfloat16)
    device_batch = {
        "x1_waveform": torch.from_numpy(wave).to(device),  # f32: kernel input
        "x2": x2.to(device),
        "label": torch.from_numpy(label).to(device),
        "idx": torch.arange(batch, dtype=torch.int64, device=device),
        "valid": torch.ones(batch, dtype=torch.float32, device=device),
    }
    return make_train_step(spec), state, device_batch, spec
