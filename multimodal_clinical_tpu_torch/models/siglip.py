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
dtype (``zoo.dot_product_attention``).  The JAX package's pipelined
stacks and sequence sharding are ROADMAP.md item 18b.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import lecun_normal_
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class Encoder(nn.Module):
    def __init__(self, layers: int, width: int, heads: int, mlp_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layers = nn.ModuleList(EncoderBlock(width, heads, mlp_dim, dtype)
                                    for _ in range(layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


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


class SigLIPTextTower(nn.Module):
    """(B, L) token ids, L <= ``text_len`` -> (B, width): the embedding
    gathered in ``dtype`` plus the first L positions, the blocks, the
    final LayerNorm, the last token through ``head``."""

    def __init__(self, dtype: Optional[torch.dtype] = None,
                 width: int = WIDTH, layers: int = LAYERS, heads: int = HEADS,
                 mlp_dim: int = MLP_DIM, text_len: int = TEXT_LEN,
                 vocab: int = VOCAB):
        super().__init__()
        self.dtype = dtype
        self.embeddings = TextEmbeddings(vocab, text_len, width)
        self.encoder = Encoder(layers, width, heads, mlp_dim, dtype)
        self.final_layer_norm = LayerNorm(width)
        self.head = Dense(width, width, dtype)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        emb = self.embeddings
        x = F.embedding(token_ids, emb.token_embedding.weight)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x + emb.position_embedding.weight[:token_ids.shape[1]].to(x.dtype)
        x = self.final_layer_norm(self.encoder(x))
        return self.head(x[:, -1])  # HF SiglipTextModel: last-token pooling


class SigLIPVisionTower(nn.Module):
    """(B, image_size, image_size, 3) pixels -> (B, width)."""

    def __init__(self, dtype: Optional[torch.dtype] = None,
                 width: int = WIDTH, layers: int = LAYERS, heads: int = HEADS,
                 mlp_dim: int = MLP_DIM, patch: int = PATCH,
                 image_size: int = IMAGE_SIZE):
        super().__init__()
        self.embeddings = VisionEmbeddings(width, patch, image_size, dtype)
        self.encoder = Encoder(layers, width, heads, mlp_dim, dtype)
        self.post_layernorm = LayerNorm(width)
        self.head = MAPHead(width, heads, mlp_dim, dtype)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        emb = self.embeddings
        x = emb.patch_embedding(pixels)
        x = x + emb.position_embedding.weight.to(x.dtype)
        return self.head(self.post_layernorm(self.encoder(x)))


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
                 vocab: int = VOCAB):
        super().__init__()
        common = dict(dtype=dtype, width=width, layers=layers, heads=heads,
                      mlp_dim=mlp_dim)
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
    ``logit_bias``, ``position_ids``) are ignored."""
    return copy_by_name(state, model, what="HF SigLIP")


def load_hf_siglip_params(checkpoint_path: str, model: SigLIPModel
                          ) -> SigLIPModel:
    """``port_siglip_state_dict`` from a local HF snapshot directory
    holding ``model.safetensors`` or ``pytorch_model.bin``
    (``pretrained.torch_state_dict``)."""
    return port_siglip_state_dict(torch_state_dict(checkpoint_path), model)
