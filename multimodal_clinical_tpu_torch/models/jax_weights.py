"""Flax -> torch weight loading: the inverse of the JAX package's
``models/torch_port.py`` functions ``port_resnet_encoder``, ``port_lenet``,
``port_gru_cell``, ``port_lstm_classifier``, ``port_resnet18_slim``,
``port_vgg11_slim``, ``port_bottleneck_encoder`` and ``port_bert``, of
``models/siglip.py``'s ``port_siglip_state_dict``, and the map of the
FakeNews ``TextTransformer``'s flax tree.

The flax trees come in as nested dicts of numpy arrays (``params`` and
``batch_stats``), so this module needs nothing of JAX.  Layouts: conv HWIO
-> OIHW, Dense (in, out) -> (out, in), ``BatchNorm_0/{scale,bias}`` ->
``weight``/``bias``, ``BatchNorm_0/{mean,var}`` -> the running buffers;
a recurrent cell's packed parameter is its gates' leaves, each in the
Dense layout, stacked in torch's gate order (``models/rnn.py``); VGG11Slim's
classifier rows are permuted from the NHWC flatten (7, 7, C) to torch's
C-major one; attention's ``DenseGeneral`` kernels (D, H, d) and (H, d, D)
flatten their head axes, and the SigLIP MAP head's query, key and value
stack into torch ``nn.MultiheadAttention``'s packed ``in_proj``; a
SigLIP position table (1, L, D) drops its leading axis; a pipelined
tower's ``pipeline/stages`` leaves keep their leading stage dim, each
stage's slice in its block's layout.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..parallel.sharding import STAGES
from .bert import BertEncoder
from .common import BatchNormBase, TorchDense
from .pretrained import BiasConv, VGG11Slim
from .resnet import BottleneckResNetEncoder, Conv, ResNetEncoder
from .rnn import _Cell
from .siglip import SigLIPModel
from .zoo import TextTransformer

# torch state_dict key -> (flax collection, path in that tree, layout kind);
# the packed parameters of a recurrent cell ("gates", "gate_biases") have a
# tuple of paths, one per gate
KeyMap = Dict[str, Tuple[str, tuple, str]]


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


def _bottleneck_keys(enc: BottleneckResNetEncoder, prefix: str,
                     path: Tuple[str, ...]) -> KeyMap:
    keys: KeyMap = {prefix + "conv1.weight":
                    ("params", path + ("Conv_0", "kernel"), "conv")}
    keys.update(_bn_keys(prefix + "bn1", path + ("_BN_0",)))
    idx = 0
    for stage, blocks in enumerate(enc.stage_sizes):
        for b in range(blocks):
            t = f"{prefix}layer{stage + 1}.{b}."
            bp = path + (f"BottleneckBlock_{idx}",)
            pairs = [("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3")]
            if getattr(enc, f"layer{stage + 1}")[b].downsample is not None:
                pairs.append(("downsample.0", "downsample.1"))
            for j, (conv, bn) in enumerate(pairs):
                keys[t + conv + ".weight"] = (
                    "params", bp + (f"Conv_{j}", "kernel"), "conv")
                keys.update(_bn_keys(t + bn, bp + (f"_BN_{j}",)))
            idx += 1
    return keys


def _text_keys(enc: TextTransformer, prefix: str,
               path: Tuple[str, ...]) -> KeyMap:
    keys: KeyMap = {
        prefix + "embedding": ("params", path + ("embed", "embedding"),
                               "vector"),
        prefix + "pos": ("params", path + ("pos",), "vector")}
    for i in range(enc.num_layers):
        for ln in (f"ln1_{i}", f"ln2_{i}"):
            keys[f"{prefix}{ln}.weight"] = ("params", path + (ln, "scale"),
                                            "vector")
            keys[f"{prefix}{ln}.bias"] = ("params", path + (ln, "bias"),
                                          "vector")
        for proj in ("query", "key", "value", "out"):
            t, p = f"{prefix}attn_{i}.{proj}.", path + (f"attn_{i}", proj)
            keys[t + "weight"] = ("params", p + ("kernel",),
                                  "heads_out" if proj == "out"
                                  else "heads_in")
            keys[t + "bias"] = ("params", p + ("bias",), "flat")
        for mlp in (f"mlp1_{i}", f"mlp2_{i}"):
            keys[f"{prefix}{mlp}.weight"] = ("params", path + (mlp, "kernel"),
                                             "dense")
            keys[f"{prefix}{mlp}.bias"] = ("params", path + (mlp, "bias"),
                                           "vector")
    return keys


def _siglip_keys(model: SigLIPModel, prefix: str,
                 path: Tuple[str, ...]) -> KeyMap:
    """HF ``SiglipModel`` names -> the flax ``SigLIPModel`` tree, the
    inverse of the JAX ``port_siglip_state_dict``."""
    keys: KeyMap = {}

    def norm(tkey, fpath):
        keys[tkey + ".weight"] = ("params", fpath + ("scale",), "vector")
        keys[tkey + ".bias"] = ("params", fpath + ("bias",), "vector")

    def dense(tkey, fpath):
        keys[tkey + ".weight"] = ("params", fpath + ("kernel",), "dense")
        keys[tkey + ".bias"] = ("params", fpath + ("bias",), "vector")

    def block(tb, pb, stacked=""):
        """One EncoderBlock; ``stacked``: the kinds' prefix of a
        ``PipelinedEncoderStack``'s blocks (a leading stage dim)."""
        for ln in ("layer_norm1", "layer_norm2"):
            keys[f"{tb}{ln}.weight"] = ("params", pb + (ln, "scale"),
                                        stacked + "vector")
            keys[f"{tb}{ln}.bias"] = ("params", pb + (ln, "bias"),
                                      stacked + "vector")
        for hf, fl in zip(("q_proj", "k_proj", "v_proj", "out_proj"),
                          ("query", "key", "value", "out")):
            pa = pb + ("self_attn", fl)
            out = fl == "out"
            keys[f"{tb}self_attn.{hf}.weight"] = (
                "params", pa + ("kernel",),
                stacked + ("heads_out" if out else "heads_in"))
            keys[f"{tb}self_attn.{hf}.bias"] = (
                "params", pa + ("bias",),
                stacked + ("vector" if out else "flat"))
        for fc in ("fc1", "fc2"):
            keys[f"{tb}mlp.{fc}.weight"] = (
                "params", pb + (f"mlp_{fc}", "kernel"), stacked + "dense")
            keys[f"{tb}mlp.{fc}.bias"] = (
                "params", pb + (f"mlp_{fc}", "bias"), stacked + "vector")

    for tower in ("text_model", "vision_model"):
        t, p = f"{prefix}{tower}.", path + (tower,)
        stack = getattr(getattr(model, tower), "pipeline", None)
        if stack is None:
            for i in range(len(getattr(model, tower).encoder.layers)):
                block(f"{t}encoder.layers.{i}.", p + (f"layers_{i}",))
        else:
            for j in range(len(stack._block.layers)):
                block(f"{t}pipeline.stages.layers.{j}.",
                      p + ("pipeline", "stages", f"layers_{j}"), STAGES)
        keys[t + "embeddings.position_embedding.weight"] = (
            "params", p + ("position_embedding",), "table")
    t, p = f"{prefix}text_model.", path + ("text_model",)
    keys[t + "embeddings.token_embedding.weight"] = (
        "params", p + ("token_embedding", "embedding"), "vector")
    norm(t + "final_layer_norm", p + ("final_layer_norm",))
    dense(t + "head", p + ("head",))
    t, p = f"{prefix}vision_model.", path + ("vision_model",)
    keys[t + "embeddings.patch_embedding.weight"] = (
        "params", p + ("patch_embedding", "kernel"), "conv")
    keys[t + "embeddings.patch_embedding.bias"] = (
        "params", p + ("patch_embedding", "bias"), "vector")
    norm(t + "post_layernorm", p + ("post_layernorm",))
    t, p = t + "head.", p + ("head",)
    keys[t + "probe"] = ("params", p + ("probe",), "vector")
    qkv = tuple(p + ("attention", fl) for fl in ("query", "key", "value"))
    keys[t + "attention.in_proj_weight"] = (
        "params", tuple(q + ("kernel",) for q in qkv), "packed_heads_in")
    keys[t + "attention.in_proj_bias"] = (
        "params", tuple(q + ("bias",) for q in qkv), "packed_flat")
    keys[t + "attention.out_proj.weight"] = (
        "params", p + ("attention", "out", "kernel"), "heads_out")
    keys[t + "attention.out_proj.bias"] = (
        "params", p + ("attention", "out", "bias"), "vector")
    norm(t + "layernorm", p + ("layernorm",))
    dense(t + "mlp.fc1", p + ("mlp_fc1",))
    dense(t + "mlp.fc2", p + ("mlp_fc2",))
    return keys


def _bert_keys(enc: BertEncoder, prefix: str,
               path: Tuple[str, ...]) -> KeyMap:
    """HF ``BertModel`` names -> the flax ``BertEncoder`` tree, the inverse
    of the JAX ``port_bert``: q/k/v kernels (D, H, d) and biases (H, d),
    the output kernel (H, d, D)."""
    e = prefix + "embeddings."
    keys: KeyMap = {
        e + "word_embeddings.weight": (
            "params", path + ("word_embeddings", "embedding"), "vector"),
        e + "position_embeddings.weight": (
            "params", path + ("position_embeddings",), "vector"),
        e + "token_type_embeddings.weight": (
            "params", path + ("token_type_embeddings",), "vector")}

    def leaf(tkey, fpath, kind):
        keys[tkey + ".weight"] = ("params", fpath + (
            "scale" if kind == "norm" else "kernel",),
            "vector" if kind == "norm" else kind)
        keys[tkey + ".bias"] = ("params", fpath + ("bias",),
                                "flat" if kind == "heads_in" else "vector")

    leaf(e + "LayerNorm", path + ("embeddings_norm",), "norm")
    for i in range(len(enc.encoder.layer)):
        t, p = f"{prefix}encoder.layer.{i}.", path + (f"layer_{i}",)
        for name in ("query", "key", "value"):
            leaf(f"{t}attention.self.{name}", p + ("attention", name),
                 "heads_in")
        leaf(t + "attention.output.dense", p + ("attention", "out"),
             "heads_out")
        leaf(t + "attention.output.LayerNorm", p + ("attention_norm",),
             "norm")
        leaf(t + "intermediate.dense", p + ("intermediate",), "dense")
        leaf(t + "output.dense", p + ("output",), "dense")
        leaf(t + "output.LayerNorm", p + ("output_norm",), "norm")
    return keys


def _leaf_keys(module: nn.Module, tkey: str, path: Tuple[str, ...]
               ) -> KeyMap:
    """The entries of one layer of a tower, ``tkey`` its torch name and
    ``path`` its flax scope."""
    if isinstance(module, TorchDense):
        dense = path + ("Dense_0",)
        return {tkey + ".weight": ("params", dense + ("kernel",), "dense"),
                tkey + ".bias": ("params", dense + ("bias",), "vector")}
    if isinstance(module, BatchNormBase):
        return _bn_keys(tkey, path)
    if isinstance(module, BiasConv):
        return {tkey + ".weight": ("params", path + ("kernel",), "conv"),
                tkey + ".bias": ("params", path + ("bias",), "vector")}
    if isinstance(module, Conv):
        return {tkey + ".weight": ("params", path + ("kernel",), "conv")}
    if isinstance(module, _Cell):
        return {f"{tkey}.{name}": (
            "params", tuple(path + (gate, leaf) for gate in gates),
            "gates" if leaf == "kernel" else "gate_biases")
            for name, (gates, leaf) in module.flax_leaves.items()}
    raise TypeError(f"no flax layout for {type(module).__name__} {tkey}")


def jax_key_map(model: nn.Module) -> KeyMap:
    """Every entry of ``model.state_dict()`` with the flax leaf it maps to.
    A tower with ``flax_names`` (torch child name -> flax scope) maps each
    named layer; a bare ``TorchDense`` is the flax ``Dense_0`` under its
    own name."""
    keys: KeyMap = {}

    def walk(module: nn.Module, name: str, path: Tuple[str, ...]):
        prefix = name + "." if name else ""
        if isinstance(module, ResNetEncoder):
            keys.update(_encoder_keys(module, prefix, path))
        elif isinstance(module, BottleneckResNetEncoder):
            keys.update(_bottleneck_keys(module, prefix, path))
        elif isinstance(module, TextTransformer):
            keys.update(_text_keys(module, prefix, path))
        elif isinstance(module, SigLIPModel):
            keys.update(_siglip_keys(module, prefix, path))
        elif isinstance(module, BertEncoder):
            keys.update(_bert_keys(module, prefix, path))
        elif hasattr(module, "flax_names"):
            for child, scope in module.flax_names.items():
                keys.update(_leaf_keys(module.get_submodule(child),
                                       prefix + child, path + (scope,)))
            if isinstance(module, VGG11Slim):
                dense = path + ("classifier", "Dense_0")
                keys[prefix + "classifier.weight"] = (
                    "params", dense + ("kernel",), "vgg_classifier")
                keys[prefix + "classifier.bias"] = (
                    "params", dense + ("bias",), "vector")
        elif isinstance(module, TorchDense):
            keys.update(_leaf_keys(module, name, path))
        else:
            for child, sub in module.named_children():
                walk(sub, prefix + child, path + (child,))

    walk(model, "", ())
    return keys


def to_torch_layout(kind: str, leaf, dtype=np.float32) -> np.ndarray:
    """A flax leaf (a list of leaves for a packed kind) in the torch
    layout of its ``kind``, as ``dtype``; a stacked kind (``STAGES``
    prefix) each stage's slice in its stage kind's."""
    if kind.startswith(STAGES):
        inner = kind[len(STAGES):]
        return np.stack([to_torch_layout(inner, a, dtype)
                         for a in np.asarray(leaf)])
    if kind == "gates":
        return np.concatenate([to_torch_layout("dense", a, dtype)
                               for a in leaf])
    if kind == "gate_biases":
        return np.concatenate([np.asarray(a, dtype) for a in leaf])
    if kind == "packed_heads_in":
        return np.concatenate([to_torch_layout("heads_in", a, dtype)
                               for a in leaf])
    if kind == "packed_flat":
        return np.concatenate([to_torch_layout("flat", a, dtype)
                               for a in leaf])
    a = np.asarray(leaf, dtype)
    if kind == "conv":
        return a.transpose(3, 2, 0, 1)   # HWIO -> OIHW
    if kind == "dense":
        return a.T                       # (in, out) -> (out, in)
    if kind == "heads_in":
        return a.reshape(a.shape[0], -1).T   # (D, H, d) -> (H * d, D)
    if kind == "heads_out":
        return a.reshape(-1, a.shape[-1]).T  # (H, d, D) -> (D, H * d)
    if kind == "flat":
        return a.reshape(-1)                 # (H, d) -> (H * d,)
    if kind == "table":
        return a[0]                          # (1, L, D) -> (L, D)
    if kind == "vgg_classifier":
        # NHWC row i * 7 * C + j * C + c -> torch column c * 49 + i * 7 + j
        c = a.shape[0] // 49
        return a.reshape(7, 7, c, -1).transpose(3, 2, 0, 1).reshape(
            a.shape[1], -1)
    return a


def get_leaf(tree: Mapping, path: tuple):
    """The leaf at ``path``, or the list of leaves at a tuple of paths."""
    if path and isinstance(path[0], tuple):
        return [get_leaf(tree, p) for p in path]
    for key in path:
        tree = tree[key]
    return tree


def load_jax_variables(model: nn.Module, params: Mapping,
                       batch_stats: Mapping, dtype=np.float32) -> nn.Module:
    """Copy a flax ``params`` / ``batch_stats`` pair into ``model`` (its
    tensors of ``dtype``: float64 for a float64 model); every state_dict
    entry must be covered (strict load)."""
    trees = {"params": params, "batch_stats": batch_stats}
    state = {
        key: torch.from_numpy(np.array(
            to_torch_layout(kind, get_leaf(trees[coll], path), dtype),
            order="C"))
        for key, (coll, path, kind) in jax_key_map(model).items()
    }
    model.load_state_dict(state, strict=True)
    return model
