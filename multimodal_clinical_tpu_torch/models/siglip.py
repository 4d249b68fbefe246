"""SigLIP-base-patch16-224 dual tower, Food101's backbone (port of
``multimodal_clinical_tpu/models/siglip.py``).

The reference fine-tunes HF ``AutoModel.from_pretrained(
"google/siglip-base-patch16-224")`` end to end (food101/joint_model.py:
36-38):

  * vision tower: ViT-B/16, a 16 x 16 / 16 patch conv, learned position
    embeddings, 12 pre-LN blocks (width 768, 12 heads, MLP 3072, tanh
    GELU), a final LayerNorm and SigLIP's MAP head (a learned probe token
    attends over the patches, then LayerNorm and a residual MLP);
  * text tower: 12 blocks over 64 tokens of a 32 000-word vocabulary, a
    final LayerNorm, the last token pooled, a linear head.

``SigLIPModel`` returns (text_embeds, image_embeds), both (B, 768) and L2
normalised in fp32, as HF's ``SiglipModel.forward`` gives the reference's
MLP heads (food101/joint_model.py:55-58).

The modules keep HF ``SiglipModel``'s ``state_dict`` names
(``text_model.encoder.layers.{i}.self_attn.q_proj.weight``,
``vision_model.head.attention.in_proj_weight``, ...), so a local HF
checkpoint loads by name (``load_hf_siglip_params``); its ``logit_scale``
and ``logit_bias`` have no place here, as in the JAX package.  Without a
checkpoint the towers start from flax's initialisers: lecun-normal
kernels, zero biases, N(0, 0.02) positions, N(0, 1 / width) token
embedding, a xavier-uniform probe.

Numerics follow the flax modules: the compute ``dtype`` (bf16 in the
config) for the projections, the patch conv, attention and the MLPs,
fp32 parameters, LayerNorms that give fp32, the softmax in the compute
dtype (``zoo.dot_product_attention``).

Two scaling switches, as in the JAX package.  ``pipeline_stages`` S > 1
holds each tower's blocks as a ``PipelinedEncoderStack``: S stages of
``layers / S`` blocks, every parameter stacked on a leading S dim under
``pipeline.stages``; it runs as GPipe over a mesh's stage axis
(``parallel/pipeline.py``) and, without one, as the sequential loop over
the stages that JAX's ``lax.scan`` gives.  ``sequence_sharding`` under a
mesh's model axis M > 1 shards the tokens between the blocks: each model
rank holds L / M of them (an indivisible L stays whole), the LayerNorms
and MLPs run on those, attention's queries are the rank's tokens and its
keys and values every token's (the LayerNorm'd tokens gathered over the
model axis), and the blocks' parameters are used whole, so their
gradients are summed over the model axis; the tokens are gathered again
before the final LayerNorm.  JAX states only the layout (``P(None,
"model")``) and GSPMD places the gathers.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..parallel.distributed import copy_to_axis, gather_from_axis, \
    gather_partial
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, STAGE_AXIS, \
    constrain_model_parallel
from .common import init_weights, lecun_normal_
from .pretrained import copy_by_name, torch_state_dict
from .zoo import Dense, LayerNorm, MultiHeadDotProductAttention

WIDTH = 768
LAYERS = 12
HEADS = 12
MLP_DIM = 3072
PATCH = 16
IMAGE_SIZE = 224
TEXT_LEN = 64
VOCAB = 32000

# HF's projection names in SiglipAttention
HF_ATTENTION = ("q_proj", "k_proj", "v_proj", "out_proj")


class Table(nn.Module):
    """A (rows, width) ``weight`` drawn from N(0, std^2): the token and
    position embeddings, under HF's ``nn.Embedding`` name."""

    def __init__(self, rows: int, width: int, std: float):
        super().__init__()
        self.std = std
        self.weight = nn.Parameter(torch.empty(rows, width))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        nn.init.normal_(self.weight, 0.0, self.std, generator=generator)


class PatchEmbedding(nn.Module):
    """The ``patch`` x ``patch`` / ``patch`` VALID conv with a bias on
    (B, H, W, 3) pixels: (B, H / patch * W / patch, width), the patches in
    row-major order.  ``weight`` in torch's OIHW layout, flax's
    lecun-normal init."""

    def __init__(self, width: int, patch: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.patch = patch
        self.weight = nn.Parameter(torch.empty(width, 3, patch, patch))
        self.bias = nn.Parameter(torch.empty(width))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = pixels.permute(0, 3, 1, 2)  # NHWC -> NCHW view: channels_last
        dtype = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        y = F.conv2d(x.to(dtype), self.weight.to(dtype), self.bias.to(dtype),
                     stride=self.patch)
        return y.flatten(2).transpose(1, 2)


class MLP(nn.Module):
    """fc1 -> tanh GELU -> fc2 (HF ``SiglipMLP``)."""

    def __init__(self, width: int, mlp_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc1 = Dense(width, mlp_dim, dtype)
        self.fc2 = Dense(mlp_dim, width, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class EncoderBlock(nn.Module):
    """Pre-LN block: x + attn(ln1(x)), then x + mlp(ln2(x))."""

    def __init__(self, width: int, heads: int, mlp_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layer_norm1 = LayerNorm(width)
        self.self_attn = MultiHeadDotProductAttention(width, heads, dtype,
                                                      HF_ATTENTION)
        self.layer_norm2 = LayerNorm(width)
        self.mlp = MLP(width, mlp_dim, dtype)

    def forward(self, x: torch.Tensor, sequence_group=None) -> torch.Tensor:
        """``sequence_group``: the model axis's group when ``x`` holds this
        rank's tokens; the keys and values then see every rank's."""
        h = self.layer_norm1(x)
        kv = h if sequence_group is None else gather_partial(
            h, 1, sequence_group)
        x = x + self.self_attn(h, kv)
        return x + self.mlp(self.layer_norm2(x))


class Encoder(nn.Module):
    def __init__(self, layers: int, width: int, heads: int, mlp_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layers = nn.ModuleList(EncoderBlock(width, heads, mlp_dim, dtype)
                                    for _ in range(layers))

    def forward(self, x: torch.Tensor, sequence_group=None) -> torch.Tensor:
        """With ``sequence_group`` the tokens are this rank's, and each
        block's parameters pass through ``copy_to_axis``: every rank's
        tokens add their part of the gradient."""
        for layer in self.layers:
            if sequence_group is None:
                x = layer(x)
            else:
                params = {n: copy_to_axis(p, sequence_group)
                          for n, p in layer.named_parameters()}
                x = functional_call(layer, params, (x, sequence_group))
        return x


class _StageBlock(nn.Module):
    """One pipeline stage: ``blocks`` consecutive EncoderBlocks (flax's
    ``layers_{j}``, torch's ``layers.{j}``)."""

    def __init__(self, blocks: int, width: int, heads: int, mlp_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layers = nn.ModuleList(EncoderBlock(width, heads, mlp_dim, dtype)
                                    for _ in range(blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


def _stacked_mirror(template: nn.Module, stages: int) -> nn.Module:
    """Plain modules with ``template``'s names, each parameter with a
    leading dim of ``stages``."""
    node = nn.Module()
    for name, p in template.named_parameters(recurse=False):
        node.register_parameter(name, nn.Parameter(
            torch.empty((stages,) + tuple(p.shape))))
    for name, child in template.named_children():
        node.add_module(name, _stacked_mirror(child, stages))
    return node


class PipelinedEncoderStack(nn.Module):
    """``stages`` GPipe stages x (``layers // stages``) EncoderBlocks, the
    parameters stacked on a leading stage dim under ``stages``
    (``parallel/sharding.py`` gives each stage rank its stage's slice).
    With a mesh whose stage axis is > 1 it runs as GPipe with ``n_micro``
    microbatches (``parallel/pipeline.py::pipeline_apply``); without one
    as the sequential loop over the stages (JAX's ``lax.scan``).  The
    stage's blocks run through ``functional_call`` of one template
    ``_StageBlock`` (not a submodule) with a stage's slice."""

    def __init__(self, layers: int, stages: int, width: int = WIDTH,
                 heads: int = HEADS, mlp_dim: int = MLP_DIM,
                 dtype: Optional[torch.dtype] = None, mesh: Any = None,
                 n_micro: int = 4):
        super().__init__()
        if layers % stages:
            raise ValueError(
                f"layers {layers} not divisible by pipeline_stages "
                f"{stages}")
        self.n_stages, self.mesh, self.n_micro = stages, mesh, n_micro
        block = _StageBlock(layers // stages, width, heads, mlp_dim, dtype)
        object.__setattr__(self, "_block", block)
        self.stages = _stacked_mirror(block, stages)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """Each stage drawn as a fresh ``_StageBlock`` (flax's per-stage
        ``block.init``)."""
        stacked = dict(self.stages.named_parameters())
        with torch.no_grad():
            for s in range(self.n_stages):
                init_weights(self._block, generator)
                for name, p in self._block.named_parameters():
                    stacked[name][s].copy_(p)

    def _block_fn(self, params: Dict[str, torch.Tensor],
                  x: torch.Tensor) -> torch.Tensor:
        return functional_call(self._block, params, (x,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stacked = dict(self.stages.named_parameters())
        shape = dict(self.mesh.shape) if self.mesh is not None else {}
        if shape.get(STAGE_AXIS, 1) > 1:
            from ..parallel.pipeline import pipeline_apply

            data_axis = DATA_AXIS if shape.get(DATA_AXIS, 1) > 1 else None
            return pipeline_apply(self.mesh, self._block_fn, stacked, x,
                                  n_micro=self.n_micro, axis=STAGE_AXIS,
                                  data_axis=data_axis)
        for s in range(self.n_stages):
            x = self._block_fn({k: v[s] for k, v in stacked.items()}, x)
        return x


def _layer_index(key: str) -> int:
    return int(key.split("_")[1])


def unstack_tower_layers(tower_params: dict) -> dict:
    """Inverse of ``stack_tower_layers`` (numpy flax trees): a pipelined
    tower (``{"pipeline": {"stages": <stacked>}}``) back to the per-layer
    ``layers_0..layers_{L-1}`` loop layout."""
    stacked = tower_params["pipeline"]["stages"]
    stages = _first_leaf(stacked).shape[0]
    out = {k: v for k, v in tower_params.items() if k != "pipeline"}
    per = len(stacked)
    for s in range(stages):
        stage = _tree_map(lambda a, s=s: np.asarray(a)[s], stacked)
        for j in range(per):
            out[f"layers_{s * per + j}"] = stage[f"layers_{j}"]
    return out


def stack_tower_layers(tower_params: dict, stages: int) -> dict:
    """One tower's per-layer flax params (``layers_0..layers_{L-1}``, numpy)
    in the PipelinedEncoderStack layout: ``{"pipeline": {"stages":
    <stacked>}}``, every leaf gaining a leading S dim (stage s, block j <-
    layer s * (L / S) + j)."""
    layer_keys = sorted((k for k in tower_params if k.startswith("layers_")),
                        key=_layer_index)
    n_layers = len(layer_keys)
    if not n_layers or n_layers % stages:
        raise ValueError(
            f"{n_layers} layers not divisible by {stages} stages")
    per = n_layers // stages
    stage_trees = [{f"layers_{j}": tower_params[layer_keys[s * per + j]]
                    for j in range(per)} for s in range(stages)]
    out = {k: v for k, v in tower_params.items()
           if not k.startswith("layers_")}
    out["pipeline"] = {"stages": _tree_map(
        lambda *leaves: np.stack([np.asarray(a) for a in leaves]),
        *stage_trees)}
    return out


def _tree_map(fn, *trees):
    if isinstance(trees[0], Mapping):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _first_leaf(tree):
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tree


class PackedAttention(MultiHeadDotProductAttention):
    """The MAP head's attention under torch ``nn.MultiheadAttention``'s
    names (HF keeps them): the query, key and value projections packed as
    the rows of ``in_proj_weight`` / ``in_proj_bias``, then ``out_proj``;
    each projection drawn as flax's."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(dim, num_heads, dtype,
                         (None, None, None, "out_proj"))
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        for w in self.in_proj_weight.data.chunk(3):
            lecun_normal_(w, w.shape[1], generator)
        nn.init.zeros_(self.in_proj_bias)

    def project(self, i: int, x: torch.Tensor) -> torch.Tensor:
        dim = self.in_proj_weight.shape[1]
        rows = slice(i * dim, (i + 1) * dim)
        dtype = self.dtype or torch.promote_types(x.dtype,
                                                  self.in_proj_weight.dtype)
        return F.linear(x.to(dtype), self.in_proj_weight[rows].to(dtype),
                        self.in_proj_bias[rows].to(dtype))


class MAPHead(nn.Module):
    """Multihead attention pooling: a learned ``probe`` attends over the
    tokens, then LayerNorm and a residual MLP: (B, L, width) ->
    (B, width)."""

    def __init__(self, width: int, heads: int, mlp_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.probe = nn.Parameter(torch.empty(1, 1, width))
        self.attention = PackedAttention(width, heads, dtype)
        self.layernorm = LayerNorm(width)
        self.mlp = MLP(width, mlp_dim, dtype)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        # flax's xavier_uniform on (1, 1, width): fan_in 1, fan_out width
        limit = math.sqrt(6.0 / (1 + self.probe.shape[-1]))
        nn.init.uniform_(self.probe, -limit, limit, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        probe = self.probe.to(x.dtype).expand(x.shape[0], 1, -1)
        h = self.attention(probe, x)
        return (h + self.mlp(self.layernorm(h)))[:, 0]


class TextEmbeddings(nn.Module):
    def __init__(self, vocab: int, text_len: int, width: int):
        super().__init__()
        self.token_embedding = Table(vocab, width, 1.0 / math.sqrt(width))
        self.position_embedding = Table(text_len, width, 0.02)


class VisionEmbeddings(nn.Module):
    def __init__(self, width: int, patch: int, image_size: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.patch_embedding = PatchEmbedding(width, patch, dtype)
        self.position_embedding = Table((image_size // patch) ** 2, width,
                                        0.02)


def _blocks(tower: nn.Module, layers: int, width: int, heads: int,
            mlp_dim: int, dtype: Optional[torch.dtype],
            pipeline_stages: int = 0, pipeline_microbatches: int = 4,
            sequence_sharding: bool = False, mesh: Any = None) -> None:
    """A tower's blocks: ``encoder`` (``layers_{i}`` in flax), or with
    ``pipeline_stages`` > 1 the stacked ``pipeline``.  ``sequence_parallel``
    tells ``parallel/sharding.py`` that the tower's Dense leaves are used
    whole (gathered), not column by column."""
    if pipeline_stages > 1:
        tower.pipeline = PipelinedEncoderStack(
            layers, pipeline_stages, width, heads, mlp_dim, dtype, mesh,
            pipeline_microbatches)
    else:
        tower.encoder = Encoder(layers, width, heads, mlp_dim, dtype)
    tower.mesh = mesh
    tower.sequence_parallel = bool(
        sequence_sharding and pipeline_stages <= 1 and mesh is not None
        and mesh.shape.get(MODEL_AXIS, 1) > 1)


def _run_blocks(tower: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The blocks on (B, L, width) tokens.  Under sequence sharding each
    model rank runs them on its L / M tokens (``constrain_model_parallel``
    to ``(None, "model")``, JAX's ``_maybe_shard_sequence``), and the
    tokens are gathered after; an indivisible L stays whole.  Within a
    pipeline the tokens stay whole, as JAX's ``shard_map`` replicates
    them over the model axis."""
    if hasattr(tower, "pipeline"):
        return tower.pipeline(x)
    mesh = tower.mesh
    if (not tower.sequence_parallel
            or x.shape[1] % mesh.shape[MODEL_AXIS]):
        return tower.encoder(x)
    group = mesh.model_group
    x = constrain_model_parallel(x, (None, MODEL_AXIS), mesh)
    return gather_from_axis(tower.encoder(x, group), 1, group)


class SigLIPTextTower(nn.Module):
    """(B, L) token ids, L <= ``text_len`` -> (B, width): the embedding
    gathered in ``dtype`` plus the first L positions, the blocks, the
    final LayerNorm, the last token through ``head``."""

    def __init__(self, dtype: Optional[torch.dtype] = None,
                 width: int = WIDTH, layers: int = LAYERS, heads: int = HEADS,
                 mlp_dim: int = MLP_DIM, text_len: int = TEXT_LEN,
                 vocab: int = VOCAB, **scaling):
        super().__init__()
        self.dtype = dtype
        self.embeddings = TextEmbeddings(vocab, text_len, width)
        _blocks(self, layers, width, heads, mlp_dim, dtype, **scaling)
        self.final_layer_norm = LayerNorm(width)
        self.head = Dense(width, width, dtype)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        emb = self.embeddings
        x = F.embedding(token_ids, emb.token_embedding.weight)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x + emb.position_embedding.weight[:token_ids.shape[1]].to(x.dtype)
        x = self.final_layer_norm(_run_blocks(self, x))
        return self.head(x[:, -1])  # HF SiglipTextModel: last-token pooling


class SigLIPVisionTower(nn.Module):
    """(B, image_size, image_size, 3) pixels -> (B, width)."""

    def __init__(self, dtype: Optional[torch.dtype] = None,
                 width: int = WIDTH, layers: int = LAYERS, heads: int = HEADS,
                 mlp_dim: int = MLP_DIM, patch: int = PATCH,
                 image_size: int = IMAGE_SIZE, **scaling):
        super().__init__()
        self.embeddings = VisionEmbeddings(width, patch, image_size, dtype)
        _blocks(self, layers, width, heads, mlp_dim, dtype, **scaling)
        self.post_layernorm = LayerNorm(width)
        self.head = MAPHead(width, heads, mlp_dim, dtype)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        emb = self.embeddings
        x = emb.patch_embedding(pixels)
        x = x + emb.position_embedding.weight.to(x.dtype)
        return self.head(self.post_layernorm(_run_blocks(self, x)))


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / ||x|| with the norm in at least fp32 (jnp.linalg.norm's sqrt of
    the sum of squares)."""
    wide = x.to(torch.promote_types(x.dtype, torch.float32))
    return x / torch.sqrt((wide * wide).sum(-1, keepdim=True))


class SigLIPModel(nn.Module):
    """Both towers; the geometry defaults to siglip-base-patch16-224, the
    tests shrink it.  forward(token_ids, pixels) -> (text, image)
    embeddings, each L2 normalised in fp32 (HF ``SiglipModel.forward``)."""

    def __init__(self, dtype: Optional[torch.dtype] = None,
                 width: int = WIDTH, layers: int = LAYERS, heads: int = HEADS,
                 mlp_dim: int = MLP_DIM, patch: int = PATCH,
                 image_size: int = IMAGE_SIZE, text_len: int = TEXT_LEN,
                 vocab: int = VOCAB, pipeline_stages: int = 0,
                 pipeline_microbatches: int = 4,
                 sequence_sharding: bool = False, mesh: Any = None):
        super().__init__()
        common = dict(dtype=dtype, width=width, layers=layers, heads=heads,
                      mlp_dim=mlp_dim, pipeline_stages=pipeline_stages,
                      pipeline_microbatches=pipeline_microbatches,
                      sequence_sharding=sequence_sharding, mesh=mesh)
        self.text_model = SigLIPTextTower(text_len=text_len, vocab=vocab,
                                          **common)
        self.vision_model = SigLIPVisionTower(patch=patch,
                                              image_size=image_size, **common)

    def forward(self, token_ids: torch.Tensor, pixels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return (_l2_normalize(self.text_model(token_ids)),
                _l2_normalize(self.vision_model(pixels)))


# -- HF weights (a local checkpoint only) -------------------------------------

def port_siglip_state_dict(state: Mapping, model: SigLIPModel
                           ) -> SigLIPModel:
    """Copy an HF ``SiglipModel`` state_dict (numpy or tensor values) into
    ``model`` by name, in place; raises on a missing key or a shape
    mismatch.  Keys the port has no place for (``logit_scale``,
    ``logit_bias``, ``position_ids``) are ignored.  A pipelined tower
    takes HF's per-layer entries stacked by stage (layer s * (L / S) + j
    as stage s's block j)."""
    state = dict(state)
    for tower in ("text_model", "vision_model"):
        stack = getattr(getattr(model, tower), "pipeline", None)
        if stack is not None:
            state.update(_stacked_hf_layers(state, tower, stack.n_stages))
    return copy_by_name(state, model, what="HF SigLIP")


def _stacked_hf_layers(state: Mapping, tower: str, stages: int) -> Dict:
    """HF's ``{tower}.encoder.layers.{i}.*`` as the pipelined tower's
    ``{tower}.pipeline.stages.layers.{j}.*``, stacked by stage."""
    pattern = re.compile(rf"{tower}\.encoder\.layers\.(\d+)\.(.+)")
    by_layer: Dict[int, Dict[str, Any]] = {}
    for key, value in state.items():
        m = pattern.fullmatch(key)
        if m:
            by_layer.setdefault(int(m.group(1)), {})[m.group(2)] = value
    if not by_layer or len(by_layer) % stages:
        raise ValueError(f"{len(by_layer)} layers not divisible by "
                         f"{stages} stages")
    per = len(by_layer) // stages
    out = {}
    for j in range(per):
        for rest in by_layer[j]:
            out[f"{tower}.pipeline.stages.layers.{j}.{rest}"] = np.stack(
                [_numpy(by_layer[s * per + j][rest]) for s in range(stages)])
    return out


def _numpy(value) -> np.ndarray:
    if torch.is_tensor(value):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def load_hf_siglip_params(checkpoint_path: str, model: SigLIPModel
                          ) -> SigLIPModel:
    """``port_siglip_state_dict`` from a local HF snapshot directory
    holding ``model.safetensors`` or ``pytorch_model.bin``
    (``pretrained.torch_state_dict``)."""
    return port_siglip_state_dict(torch_state_dict(checkpoint_path), model)
