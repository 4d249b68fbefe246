"""EMA logit-offset calibration (port of
``multimodal_clinical_tpu/algos/ema.py``; reference utils/EMA.py:3-38).

The state is a (num_modality, num_classes) fp32 tensor on the device.
``ema_update`` runs before the calibrated accuracies are read
(BaseModel.py:83-89), so the offset includes the current batch.
"""

from __future__ import annotations

import torch

DEFAULT_SMOOTHING = 0.05


def ema_update(ema_x: torch.Tensor, batch_mean_logits: torch.Tensor,
               smoothing: float = DEFAULT_SMOOTHING) -> torch.Tensor:
    """One EMA step. Both tensors are (M, C); accumulation in fp32."""
    return batch_mean_logits.float() * smoothing + ema_x * (1.0 - smoothing)


def ema_offset(ema_x: torch.Tensor) -> torch.Tensor:
    """Per-modality offset: mean over modalities minus the modality's EMA."""
    return ema_x.mean(dim=0, keepdim=True) - ema_x


def masked_batch_mean(logits: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """(B, C) -> (C,) mean over the valid (non-padding) rows."""
    valid = valid.to(logits.dtype)
    denom = torch.clamp(valid.sum(), min=1.0)
    return (logits * valid[:, None]).sum(dim=0) / denom
