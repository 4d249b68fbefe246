"""OGM-GE: On-the-fly Gradient Modulation with Generalized noise Enhancement
(port of ``multimodal_clinical_tpu/algos/ogm_ge.py``).

The reference mutates ``.grad`` in place between ``backward()`` and
``opt.step()`` (existing_algos/OGM_GE.py:4-57, utils/BaseModel.py:870-875);
so does ``modulate_gradients``.  Semantics, quirks included:

  * per-modality sums of the softmax probability at the true class
    (OGM_GE.py:21-22), vectorised, computed from the raw per-modality
    logits;
  * the coefficient ``1 - tanh(alpha * relu(ratio))`` applies only to the
    *dominant* modality (OGM_GE.py:35-40); the other keeps 1;
  * only the 4-D (conv-weight) gradients of ``model.x1_model`` and
    ``model.x2_model`` are modulated (OGM_GE.py:45-47): BatchNorm and
    classifier parameters are not;
  * Gaussian noise scaled by the gradient's Bessel-corrected std + 1e-8
    (OGM_GE.py:48-50);
  * weight decay is not modulated: ``torch.optim.SGD`` adds it inside
    ``step()``, after this function ran.

No value is read back to the host: the coefficients stay device scalars.
The noise comes from a ``NoiseSource`` argument; ``device_noise`` draws it
on the gradients' device from a generator seeded from (seed, step), so a
resumed run draws the same noise.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..engine.state import mixed_seed

MODULATION_MODES = ("OGM_GE", "OGM", "noise")
DEFAULT_ENCODER_KEYS = ("x1_model", "x2_model")

# (parameter name, gradient) -> standard-normal fp32 tensor of the
# gradient's shape, on its device
NoiseSource = Callable[[str, torch.Tensor], torch.Tensor]


def gt_softmax_scores(logits: torch.Tensor, label: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum over the batch of the softmax probability at the true class."""
    probs = F.softmax(logits.float(), dim=-1)
    picked = probs.gather(-1, label[:, None].long())[:, 0]
    if valid is not None:
        picked = picked * valid.to(picked.dtype)
    return picked.sum()


def ogm_coefficients(x1_logits: torch.Tensor, x2_logits: torch.Tensor,
                     label: torch.Tensor, alpha: float,
                     valid: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(coeff_1, coeff_2) device scalars (OGM_GE.py:24-40): modality 1
    ("v") is x1, modality 2 ("a") is x2; the one with the higher
    ground-truth score is suppressed."""
    score_v = gt_softmax_scores(x1_logits, label, valid)
    score_a = gt_softmax_scores(x2_logits, label, valid)
    ratio_v = score_v / score_a
    ratio_a = 1.0 / ratio_v
    suppress_v = 1.0 - torch.tanh(alpha * F.relu(ratio_v))
    suppress_a = 1.0 - torch.tanh(alpha * F.relu(ratio_a))
    v_dominant = ratio_v > 1.0
    one = torch.ones_like(ratio_v)
    return (torch.where(v_dominant, suppress_v, one),
            torch.where(v_dominant, one, suppress_a))


def modulated_parameters(model: nn.Module,
                         encoder_keys: Sequence[str] = DEFAULT_ENCODER_KEYS
                         ) -> Iterator[Tuple[int, str, nn.Parameter]]:
    """(encoder position, name, parameter) of every 4-D parameter under
    the encoders named by ``encoder_keys``, in ``named_parameters`` order."""
    for i, key in enumerate(encoder_keys):
        encoder = getattr(model, key, None)
        if encoder is None:
            continue
        for name, param in encoder.named_parameters():
            if param.ndim == 4:
                yield i, f"{key}.{name}", param


def device_noise(seed: int, step: int) -> NoiseSource:
    """Standard-normal draws on each gradient's device, one generator per
    device seeded from (seed, step), drawn in the order asked."""
    generators = {}

    def draw(name: str, grad: torch.Tensor) -> torch.Tensor:
        gen = generators.get(grad.device)
        if gen is None:
            gen = torch.Generator(device=grad.device)
            # a stream apart from the step's SpecAugment generator
            gen.manual_seed(mixed_seed(seed, step, stream=1))
            generators[grad.device] = gen
        return torch.randn(grad.shape, generator=gen, device=grad.device,
                           dtype=torch.float32)

    return draw


@torch.no_grad()
def modulate_gradients(
    model: nn.Module,
    x1_logits: torch.Tensor,
    x2_logits: torch.Tensor,
    label: torch.Tensor,
    noise: Optional[NoiseSource] = None,
    alpha: float = 0.1,
    modulation: str = "OGM_GE",
    encoder_keys: Sequence[str] = DEFAULT_ENCODER_KEYS,
    valid: Optional[torch.Tensor] = None,
) -> None:
    """Modulate, in place, the ``.grad`` of the conv weights of the
    encoders named by ``encoder_keys``; call between ``loss.backward()``
    and ``optimizer.step()``."""
    if modulation not in MODULATION_MODES:
        raise ValueError(f"modulation must be one of {MODULATION_MODES}")
    if modulation != "OGM" and noise is None:
        raise ValueError(f"modulation {modulation!r} needs a noise source")
    coeffs = ogm_coefficients(x1_logits.detach(), x2_logits.detach(), label,
                              alpha, valid)
    for i, name, param in modulated_parameters(model, encoder_keys):
        g = param.grad
        if g is None:
            continue
        new = g.float()
        if modulation != "noise":
            new = new * coeffs[i]
        if modulation != "OGM":
            std = new.new_zeros(()) if g.numel() <= 1 else g.float().std()
            new = new + noise(name, g) * (std + 1e-8)
        g.copy_(new)
