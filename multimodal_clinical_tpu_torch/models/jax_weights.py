"""Flax -> torch weight loading: the inverse of the JAX package's
``models/torch_port.py::port_resnet_encoder``.

The flax trees come in as nested dicts of numpy arrays (``params`` and
``batch_stats``), so this module needs nothing of JAX.  Layouts: conv HWIO
-> OIHW, Dense (in, out) -> (out, in), ``BatchNorm_0/{scale,bias}`` ->
``weight``/``bias``, ``BatchNorm_0/{mean,var}`` -> the running buffers.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .common import TorchDense
from .resnet import ResNetEncoder

# torch state_dict key -> (flax collection, path in that tree, layout kind)
KeyMap = Dict[str, Tuple[str, Tuple[str, ...], str]]


def _bn_keys(tkey: str, path: Tuple[str, ...]) -> KeyMap:
    bn = path + ("BatchNorm_0",)
    return {
        tkey + ".weight": ("params", bn + ("scale",), "vector"),
        tkey + ".bias": ("params", bn + ("bias",), "vector"),
        tkey + ".running_mean": ("batch_stats", bn + ("mean",), "vector"),
        tkey + ".running_var": ("batch_stats", bn + ("var",), "vector"),
    }


def _encoder_keys(enc: ResNetEncoder, prefix: str,
                  path: Tuple[str, ...]) -> KeyMap:
    keys: KeyMap = {prefix + "conv1.weight":
                    ("params", path + ("Conv_0", "kernel"), "conv")}
    keys.update(_bn_keys(prefix + "bn1", path + ("_BN_0",)))
    idx = 0
    for stage, blocks in enumerate(enc.stage_sizes):
        for b in range(blocks):
            t = f"{prefix}layer{stage + 1}.{b}."
            bp = path + (f"BasicBlock_{idx}",)
            block = getattr(enc, f"layer{stage + 1}")[b]
            pairs = [("conv1", "bn1"), ("conv2", "bn2")]
            if block.downsample is not None:
                pairs.append(("downsample.0", "downsample.1"))
            for j, (conv, bn) in enumerate(pairs):
                keys[t + conv + ".weight"] = (
                    "params", bp + (f"Conv_{j}", "kernel"), "conv")
                keys.update(_bn_keys(t + bn, bp + (f"_BN_{j}",)))
            idx += 1
    return keys


def jax_key_map(model: nn.Module) -> KeyMap:
    """Every entry of ``model.state_dict()`` with the flax leaf it maps to."""
    keys: KeyMap = {}
    for name, module in model.named_modules():
        prefix = name + "." if name else ""
        path = tuple(name.split(".")) if name else ()
        if isinstance(module, ResNetEncoder):
            keys.update(_encoder_keys(module, prefix, path))
        elif isinstance(module, TorchDense):
            dense = path + ("Dense_0",)
            keys[prefix + "weight"] = ("params", dense + ("kernel",), "dense")
            keys[prefix + "bias"] = ("params", dense + ("bias",), "vector")
    return keys


def to_torch_layout(kind: str, leaf) -> np.ndarray:
    """A flax leaf in the torch layout of its ``kind``."""
    a = np.asarray(leaf, np.float32)
    if kind == "conv":
        return a.transpose(3, 2, 0, 1)   # HWIO -> OIHW
    if kind == "dense":
        return a.T                       # (in, out) -> (out, in)
    return a


def get_leaf(tree: Mapping, path: Tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def load_jax_variables(model: nn.Module, params: Mapping,
                       batch_stats: Mapping) -> nn.Module:
    """Copy a flax ``params`` / ``batch_stats`` pair into ``model``; every
    state_dict entry must be covered (strict load)."""
    trees = {"params": params, "batch_stats": batch_stats}
    state = {
        key: torch.from_numpy(np.array(
            to_torch_layout(kind, get_leaf(trees[coll], path)), order="C"))
        for key, (coll, path, kind) in jax_key_map(model).items()
    }
    model.load_state_dict(state, strict=True)
    return model
