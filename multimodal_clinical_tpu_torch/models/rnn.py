"""Recurrent encoders: GRU (MIMIC time series) and LSTM (MUsTARD affect)
(port of ``multimodal_clinical_tpu/models/rnn.py``).

``GRUNet``: reference mimic/joint_model.py:40-70, a 1-layer GRU over the
(B, 24, 12) series, last hidden state -> 64 -> 32 -> C.
``LstmClassifier``: reference mustard/joint_model.py:9-43, input projection
to 384, a 1-layer LSTM, last hidden state -> 100 -> ReLU -> C.

The cells are flax's, not torch's.  flax's ``GRUCell`` has biases on the
input side (``ir``, ``iz``, ``in``) and on ``hn`` only; its
``OptimizedLSTMCell`` has no input-side bias at all.  ``torch.nn.GRU`` and
``torch.nn.LSTM`` carry two bias vectors that sum into each gate, and two
trained biases move a gate twice as fast as one, so the cells here hold
exactly flax's parameters, packed in torch's gate order (``weight_ih_l0``
= [W_ir; W_iz; W_in] or [W_ii; W_if; W_ig; W_io], and so on) under
torch's names; ``models/jax_weights.py`` maps each slice to its flax
leaf.  Every leaf starts U(-1/sqrt(H), 1/sqrt(H)), as flax's and torch's.

Cast points are flax's: the gates compute in ``dtype`` (bf16 for MIMIC),
the carry starts in fp32 (flax's ``param_dtype``) and stays fp32, because
``(1 - z) * n + z * h`` and ``f * c + i * g`` promote.  The input
projections of all steps run as one matmul before the loop over T.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import TorchDense


class _Cell(nn.Module):
    """Packed gate parameters; ``flax_leaves`` names, per parameter, the
    flax Dense scopes whose leaf (``kernel`` or ``bias``) each slice is, in
    order."""

    flax_leaves: Dict[str, Tuple[Tuple[str, ...], str]] = {}

    def __init__(self, input_size: int, hidden: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        for name, (gates, leaf) in self.flax_leaves.items():
            fan = input_size if name.startswith("weight_ih") else hidden
            shape = (len(gates) * hidden,) + ((fan,) if leaf == "kernel"
                                              else ())
            self.register_parameter(name, nn.Parameter(torch.empty(shape)))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        bound = 1.0 / math.sqrt(self.hidden)
        for param in self.parameters(recurse=False):
            nn.init.uniform_(param, -bound, bound, generator=generator)

    def compute_dtype(self, x: torch.Tensor) -> torch.dtype:
        return self.dtype or torch.promote_types(x.dtype,
                                                 self.weight_ih_l0.dtype)

    def carry(self, x: torch.Tensor) -> torch.Tensor:
        """A zero carry in the parameters' dtype (fp32)."""
        return x.new_zeros((x.shape[0], self.hidden),
                           dtype=self.weight_ih_l0.dtype)


class GRUCell(_Cell):
    """flax ``GRUCell`` over a (B, T, F) sequence -> last hidden (B, H)."""

    flax_leaves = {
        "weight_ih_l0": (("ir", "iz", "in"), "kernel"),
        "bias_ih_l0": (("ir", "iz", "in"), "bias"),
        "weight_hh_l0": (("hr", "hz", "hn"), "kernel"),
        "bias_hn_l0": (("hn",), "bias"),
    }

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype(x)
        w_hh, b_hn = self.weight_hh_l0.to(dtype), self.bias_hn_l0.to(dtype)
        xi = F.linear(x.transpose(0, 1).to(dtype), self.weight_ih_l0.to(dtype),
                      self.bias_ih_l0.to(dtype))          # (T, B, 3H)
        h = self.carry(x)
        for t in range(xi.shape[0]):
            xr, xz, xn = xi[t].chunk(3, dim=-1)
            hr, hz, hn = F.linear(h.to(dtype), w_hh).chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * (hn + b_hn))
            h = (1.0 - z) * n + z * h
        return h


class LSTMCell(_Cell):
    """flax ``OptimizedLSTMCell`` over a (B, T, F) sequence -> last hidden
    (B, H)."""

    flax_leaves = {
        "weight_ih_l0": (("ii", "if", "ig", "io"), "kernel"),
        "weight_hh_l0": (("hi", "hf", "hg", "ho"), "kernel"),
        "bias_hh_l0": (("hi", "hf", "hg", "ho"), "bias"),
    }

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype(x)
        w_hh, b_hh = self.weight_hh_l0.to(dtype), self.bias_hh_l0.to(dtype)
        xi = F.linear(x.transpose(0, 1).to(dtype),
                      self.weight_ih_l0.to(dtype))        # (T, B, 4H)
        c = h = self.carry(x)
        for t in range(xi.shape[0]):
            gates = F.linear(h.to(dtype), w_hh, b_hh) + xi[t]
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        return h


class GRUNet(nn.Module):
    """(B, T, input_size) -> (B, num_classes)."""

    def __init__(self, input_size: int = 12, hidden_dim: int = 32,
                 num_classes: int = 6, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.gru = GRUCell(input_size, hidden_dim, dtype)
        self.fc1 = TorchDense(hidden_dim, 64, dtype)
        self.fc2 = TorchDense(64, 32, dtype)
        self.fc3 = TorchDense(32, num_classes, dtype)
        self.flax_names = {"gru": "GRUCell_0", "fc1": "TorchDense_0",
                           "fc2": "TorchDense_1", "fc3": "TorchDense_2"}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.fc1(self.gru(x)))
        return self.fc3(F.relu(self.fc2(h)))


class LstmClassifier(nn.Module):
    """(B, S, input_size) -> (B, num_classes); the reference's names
    ``fc1``, ``lstm``, ``fc2``, ``fc3``."""

    def __init__(self, input_size: int, num_classes: int,
                 hidden_dim: int = 384, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc1 = TorchDense(input_size, hidden_dim, dtype)
        self.lstm = LSTMCell(hidden_dim, hidden_dim, dtype)
        self.fc2 = TorchDense(hidden_dim, 100, dtype)
        self.fc3 = TorchDense(100, num_classes, dtype)
        self.flax_names = {"fc1": "TorchDense_0",
                           "lstm": "OptimizedLSTMCell_0",
                           "fc2": "TorchDense_1", "fc3": "TorchDense_2"}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.lstm(self.fc1(x))
        return self.fc3(F.relu(self.fc2(h)))
