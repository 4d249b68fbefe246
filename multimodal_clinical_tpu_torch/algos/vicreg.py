"""VICReg (variance + invariance + covariance) regulariser (port of
``multimodal_clinical_tpu/algos/vicreg.py``).

The reference formula (enrico/ensemble_model_vicreg.py:13-45); the train
loss adds it at weight 0.1 to the ensemble losses
(ensemble_model_vicreg.py:151).  ``valid`` masks padded tail-batch rows
out of every statistic, so the result equals the reference's on its
smaller last batch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def vicreg_loss(z_a: torch.Tensor, z_b: torch.Tensor,
                valid: Optional[torch.Tensor] = None,
                eps: float = 1e-8) -> torch.Tensor:
    """VICReg between two (N, D) embedding batches (Bessel-corrected
    variance).  ``valid``: optional (N,) 0/1 mask of real rows."""
    z_a, z_b = z_a.float(), z_b.float()
    n, d = z_a.shape
    v = (torch.ones(n, dtype=torch.float32, device=z_a.device)
         if valid is None else valid.float())
    vcol = v[:, None]
    k = v.sum()

    mean_a = (z_a * vcol).sum(dim=0) / k
    mean_b = (z_b * vcol).sum(dim=0) / k
    var_a = (vcol * (z_a - mean_a) ** 2).sum(dim=0) / (k - 1.0)
    var_b = (vcol * (z_b - mean_b) ** 2).sum(dim=0) / (k - 1.0)
    loss_var = (F.relu(1.0 - torch.sqrt(var_a + eps)).mean()
                + F.relu(1.0 - torch.sqrt(var_b + eps)).mean())

    loss_inv = (vcol * (z_a - z_b) ** 2).sum() / (k * d)

    za_c = (z_a - mean_a) * vcol
    zb_c = (z_b - mean_b) * vcol
    cov_a = (za_c.T @ za_c / (k - 1.0)) ** 2
    cov_b = (zb_c.T @ zb_c / (k - 1.0)) ** 2
    loss_cov = ((cov_a.sum() - torch.diagonal(cov_a).sum()) / d
                + (cov_b.sum() - torch.diagonal(cov_b).sum()) / d)
    return loss_var + loss_inv + loss_cov
