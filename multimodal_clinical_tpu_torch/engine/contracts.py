"""Fusion, loss and metric math (port of
``multimodal_clinical_tpu/engine/contracts.py``).  Padding rows of
fixed-size batches are excluded through the ``valid`` mask."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

LOGPROB_EPS = 1e-9  # reference epsilon (cremad/joint_model_proba.py:26)


def masked_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean of per-sample values over valid rows."""
    valid = valid.float()
    return (x.float() * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE with integer labels (nn.CrossEntropyLoss semantics) —
    softmax CE even when ``logits`` are log-probs, as the reference feeds
    log-probs back through nn.CrossEntropyLoss
    (cremad/joint_model_proba.py:64)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, label[:, None].long())[:, 0]
    if valid is None:
        return nll.mean()
    return masked_mean(nll, valid)


def accuracy(logits: torch.Tensor, label: torch.Tensor,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    correct = (logits.argmax(dim=-1) == label).float()
    if valid is None:
        return correct.mean()
    return masked_mean(correct, valid)


def fuse_logits(logits_list: Sequence[torch.Tensor],
                weights: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Late fusion of unimodal logits: the arithmetic mean
    (joint_model.py:56), or with ``weights`` the MIMIC ensemble's weighted
    sum ``w1*l1 + w2*l2`` (mimic/ensemble_model.py:127-128, 157)."""
    stack = torch.stack([l.float() for l in logits_list])
    if weights is None:
        return stack.mean(dim=0)
    w = torch.tensor(weights, dtype=torch.float32,
                     device=stack.device).reshape(-1, 1, 1)
    return (stack * w).sum(dim=0)


def to_logprobs(logits_list: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per-modality log(softmax + eps) (cremad/joint_model_proba.py:55-62)."""
    return [torch.log(F.softmax(l.float(), dim=-1) + LOGPROB_EPS)
            for l in logits_list]


def fuse_probas(logits_list: Sequence[torch.Tensor]) -> torch.Tensor:
    """log(mean of softmax probabilities + eps) — jprobas fused output."""
    probs = torch.stack([F.softmax(l.float(), dim=-1)
                         for l in logits_list]).mean(dim=0)
    return torch.log(probs + LOGPROB_EPS)


def offset_correct(logits_nmc: torch.Tensor) -> torch.Tensor:
    """Full-epoch unimodal offset correction (BaseModel.py:174-197).

    logits_nmc: (N, M, C).  offset = mean-over-modalities of per-modality
    mean logits, minus the per-modality mean; added to every sample.
    """
    m_out = logits_nmc.mean(dim=0)                             # (M, C)
    offset = m_out.mean(dim=0, keepdim=True) - m_out           # (M, C)
    return logits_nmc + offset
