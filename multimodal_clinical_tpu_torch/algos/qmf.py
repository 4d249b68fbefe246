"""QMF: Quality-aware Multimodal Fusion on the device (port of
``multimodal_clinical_tpu/algos/qmf.py``).

The per-sample History (existing_algos/QMF.py:5-141) lives in two
(M, n_train) fp32 device tensors of the TrainState, updated by a scatter
on the batch's global ``idx``; nothing goes through the host.

  * ``df`` — dynamic fusion: energy-based confidence
    ``logsumexp(logits) / 10`` per modality; the fused logits are the
    confidence-weighted sum with the weights detached (QMF.py:109-117),
    while the returned ``conf`` keeps its graph for ``reg_loss``.
  * ``history_update`` — EMA (alpha 0.1) of per-sample "correctness".  As
    in the reference, the value written is the *batch-mean* unimodal CE,
    broadcast to every index of the batch
    (cremad/joint_model_qmf.py:62-65 passes the scalar ``loss_uni[n]``).
  * ``target_margin`` — pairwise normalised-correctness target and margin
    (QMF.py:45-68), normalised by the full table's min and max.
  * ``reg_loss`` — per-modality margin ranking loss against the next row
    of the batch (QMF.py:119-141), with the JAX package's documented
    per-modality reading of the reference's indexing, and its partner
    rule for a padded tail batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

HISTORY_ALPHA = 0.1
ENERGY_SCALE = 10.0


def df(logits_stack: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, B, C) unimodal logits -> (fused (B, C), conf (M, B)); no
    gradient through the fusion weights, a gradient through ``conf``."""
    x = logits_stack.float()
    conf = torch.logsumexp(x, dim=-1) / ENERGY_SCALE
    fused = (x * conf.detach()[..., None]).sum(dim=0)
    return fused, conf


def history_update(
    correctness: torch.Tensor,
    confidence: torch.Tensor,
    idx: torch.Tensor,
    batch_loss: torch.Tensor,
    batch_conf: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    alpha: float = HISTORY_ALPHA,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One modality's (n,) tables with the rows at ``idx`` updated; new
    tensors, the inputs are left as they were.

    Invalid rows are dropped before the scatter: they write to a discard
    slot past the table's end, as the JAX function's out-of-bounds index
    with ``mode="drop"``.  The loader pads a tail batch by repeating the
    last real row, ``idx`` included, and a scatter with duplicate indices
    has no defined winner on CUDA, so masking the values would not do.

    A valid ``idx`` may also appear twice: the train sampler draws with
    replacement.  Of such rows only the last writes (the others go to the
    discard slot too), so the table is the same on every device and run,
    and equal to the JAX function's on the CPU, whose scatter applies the
    rows in order."""
    loss_val = batch_loss.detach().to(correctness.dtype)
    conf_val = batch_conf.detach().to(confidence.dtype)
    n = correctness.shape[0]
    idx = idx.long()
    if valid is not None:
        idx = torch.where(valid.bool(), idx, torch.full_like(idx, n))
    # row i writes only if no later row holds the same idx
    later = torch.triu(idx[:, None] == idx[None, :], diagonal=1).any(dim=1)
    idx = torch.where(later, torch.full_like(idx, n), idx)
    corr = torch.cat([correctness, correctness.new_zeros(1)])
    conf = torch.cat([confidence, confidence.new_zeros(1)])
    new_corr = (1.0 - alpha) * corr[idx] + alpha * loss_val
    corr[idx] = new_corr
    conf[idx] = conf_val
    return corr[:n], conf[:n]


def _normalize(table: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Min/max normalisation of values by the full table's range
    (QMF.py:36-43)."""
    t_min, t_max = table.min(), table.max()
    return (values - t_min) / (t_max - t_min + 1e-12)


def target_margin(correctness: torch.Tensor, idx1: torch.Tensor,
                  idx2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise ranking target (+1/-1/0) and margin |t1 - t2|
    (QMF.py:45-68)."""
    t1 = _normalize(correctness, correctness[idx1.long()])
    t2 = _normalize(correctness, correctness[idx2.long()])
    return torch.sign(t1 - t2), torch.abs(t1 - t2)


def reg_loss(conf: torch.Tensor, idx: torch.Tensor, correctness: torch.Tensor,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """History-based confidence ranking regulariser, summed over
    modalities.  conf: (M, B) from ``df``; correctness: (M, n) tables after
    this batch's update (the reference's call order,
    cremad/joint_model_qmf.py:62-67)."""
    batch = idx.shape[0]
    pos = torch.arange(batch, device=idx.device)
    if valid is not None:
        # the reference rolls within its smaller last batch: row i's
        # partner is row (i + 1) mod K over the K real rows, a prefix
        k = torch.clamp(valid.sum().to(torch.int64), min=1)
        partner = torch.where(pos + 1 >= k, torch.zeros_like(pos), pos + 1)
        pair_valid = valid.float()
        denom = torch.clamp(valid.float().sum(), min=1.0)
    else:
        partner = torch.roll(pos, -1)
        pair_valid = None
    idx2 = idx[partner]
    losses = []
    for n in range(conf.shape[0]):
        tgt, mgn = target_margin(correctness[n], idx, idx2)
        tgt, mgn = tgt.detach(), mgn.detach()
        tgt_nonzero = torch.where(tgt == 0, torch.ones_like(tgt), tgt)
        input2 = conf[n][partner] + mgn / tgt_nonzero
        per_pair = F.relu(tgt * (conf[n] - input2))
        if pair_valid is not None:
            losses.append((per_pair * pair_valid).sum() / denom)
        else:
            losses.append(per_pair.mean())
    return torch.stack(losses).sum()


def init_history(num_modality: int, n_data: int, device="cpu"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fresh (correctness, confidence) tables, (M, n_data) fp32 zeros."""
    return (torch.zeros(num_modality, n_data, dtype=torch.float32,
                        device=device),
            torch.zeros(num_modality, n_data, dtype=torch.float32,
                        device=device))
