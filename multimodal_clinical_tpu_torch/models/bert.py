"""BERT-base text encoder, post-LayerNorm, for Food101's legacy towers
(port of ``multimodal_clinical_tpu/models/bert.py``).

Reference: food101/joint_model_proba_logits.py:12-27, a frozen
``BertForTokenClassification('bert-base-uncased')`` whose last hidden
states feed a trainable ``Linear(768, C)`` on the [CLS] token.  This is
HF ``BertModel``'s architecture: word, position and token-type
embeddings with a LayerNorm of eps 1e-12, then 12 post-LN layers (width
768, 12 heads, an exact-GELU intermediate of 3072), all with dropout 0.1.

The modules keep HF ``BertModel``'s ``state_dict`` names
(``embeddings.word_embeddings.weight``,
``encoder.layer.{i}.attention.self.query.weight``,
``encoder.layer.{i}.attention.output.LayerNorm.weight``, ...), so a local
HF checkpoint loads by name (``load_hf_bert_params``); its pooler has no
place here.  Without a checkpoint the encoder starts from flax's
initialisers: lecun-normal kernels, zero biases, N(0, 1 / width) word
embeddings, N(0, 0.02) position and token-type tables.

Numerics follow the flax modules: the embeddings gathered and summed in
the compute ``dtype``, LayerNorms that give fp32 (so the residual stream
is fp32 after the first), projections, attention and the MLP in the
compute dtype, fp32 parameters.  The attention mask is ``ids != 0`` (pad
id 0, right-padded rows).  In train mode the dropouts draw their masks
in flax's order: the embeddings', then per layer the attention weights'
(one (1, 1, L, L) mask, ``zoo.dot_product_attention``), the attention
output's and the FFN output's.
"""

from __future__ import annotations

import contextlib
import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .common import Dropout, TorchDense
from .pretrained import copy_by_name, torch_state_dict
from .siglip import Table
from .zoo import Dense, LayerNorm, MultiHeadDotProductAttention

VOCAB = 30522
WIDTH = 768
LAYERS = 12
HEADS = 12
MLP_DIM = 3072
MAX_POS = 512
EPS = 1e-12
PAD_ID = 0
DROPOUT = 0.1


class BertEmbeddings(nn.Module):
    def __init__(self, vocab: int, width: int, max_pos: int, dropout: float):
        super().__init__()
        self.word_embeddings = Table(vocab, width, 1.0 / math.sqrt(width))
        self.position_embeddings = Table(max_pos, width, 0.02)
        self.token_type_embeddings = Table(2, width, 0.02)
        self.LayerNorm = LayerNorm(width, EPS)
        self.dropout = Dropout(dropout)


class DenseNorm(nn.Module):
    """HF's ``BertSelfOutput`` / ``BertOutput``: ``dense``, dropout, then
    ``LayerNorm`` of the residual sum."""

    def __init__(self, cin: int, width: int, dropout: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dense = Dense(cin, width, dtype)
        self.dropout = Dropout(dropout)
        self.LayerNorm = LayerNorm(width, EPS)

    def forward(self, h: torch.Tensor, residual: torch.Tensor
                ) -> torch.Tensor:
        return self.LayerNorm(residual + self.dropout(self.dense(h)))


class BertAttention(nn.Module):
    """HF's ``attention.self`` (query, key and value, the attention-weight
    dropout) and ``attention.output`` (the output projection, dropout and
    the post-LN)."""

    def __init__(self, width: int, heads: int, dropout: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.self = MultiHeadDotProductAttention(
            width, heads, dtype, ("query", "key", "value", None), dropout)
        self.output = DenseNorm(width, width, dropout, dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.output(self.self.attend(x, mask=mask), x)


class Intermediate(nn.Module):
    def __init__(self, width: int, mlp_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dense = Dense(width, mlp_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.dense(x))  # HF BERT's exact (erf) GELU


class BertLayer(nn.Module):
    """One post-LN layer: attention_norm(x + attn), then
    output_norm(x + FFN(x))."""

    def __init__(self, width: int, heads: int, mlp_dim: int, dropout: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.attention = BertAttention(width, heads, dropout, dtype)
        self.intermediate = Intermediate(width, mlp_dim, dtype)
        self.output = DenseNorm(mlp_dim, width, dropout, dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.attention(x, mask)
        return self.output(self.intermediate(x), x)


class Encoder(nn.Module):
    def __init__(self, layers: int, width: int, heads: int, mlp_dim: int,
                 dropout: float, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layer = nn.ModuleList(
            BertLayer(width, heads, mlp_dim, dropout, dtype)
            for _ in range(layers))


class BertEncoder(nn.Module):
    """ids (B, L) int, L <= ``max_pos`` -> the last layer's hidden states
    (B, L, width), fp32."""

    def __init__(self, vocab_size: int = VOCAB, width: int = WIDTH,
                 num_layers: int = LAYERS, heads: int = HEADS,
                 mlp_dim: int = MLP_DIM, max_pos: int = MAX_POS,
                 dropout: float = DROPOUT,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.embeddings = BertEmbeddings(vocab_size, width, max_pos, dropout)
        self.encoder = Encoder(num_layers, width, heads, mlp_dim, dropout,
                               dtype)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        emb = self.embeddings
        x = F.embedding(ids, emb.word_embeddings.weight)
        if self.dtype is not None:
            x = x.to(self.dtype)
        # single-segment inputs: token type 0 for every token
        x = (x + emb.position_embeddings.weight[:ids.shape[1]].to(x.dtype)
             + emb.token_type_embeddings.weight[0].to(x.dtype))
        x = emb.dropout(emb.LayerNorm(x))
        mask = (ids != PAD_ID)[:, None, None, :]  # (B, 1, 1, L)
        for layer in self.encoder.layer:
            x = layer(x, mask)
        return x


class BertClassifier(nn.Module):
    """BERT (``model``) and a ``TorchDense`` ``classifier`` on the [CLS]
    token (food101/joint_model_proba_logits.py:12-27).  With
    ``freeze_backbone`` the encoder runs under ``torch.no_grad()``, the
    twin of the JAX package's ``stop_gradient`` and of
    ``requires_grad=False``: its parameters get no gradient, and in train
    mode its dropouts still draw."""

    def __init__(self, num_classes: int, freeze_backbone: bool = True,
                 num_layers: int = LAYERS, width: int = WIDTH,
                 heads: int = HEADS, vocab_size: int = VOCAB,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.freeze_backbone = freeze_backbone
        self.model = BertEncoder(vocab_size, width, num_layers, heads,
                                 4 * width, dtype=dtype)
        self.classifier = TorchDense(width, num_classes, dtype)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        with (torch.no_grad() if self.freeze_backbone
              else contextlib.nullcontext()):
            cls = self.model(ids)[:, 0]
        return self.classifier(cls)


# -- HF weights (a local checkpoint only) -------------------------------------

def port_bert_state_dict(state: Mapping, model: BertEncoder,
                         prefix: str = "") -> BertEncoder:
    """Copy an HF ``BertModel`` state_dict (numpy or tensor values; its
    keys under ``prefix``, ``"bert."`` for a ``BertFor...`` checkpoint)
    into ``model`` by name, in place; raises on a missing key or a shape
    mismatch.  Keys the encoder has no place for (``pooler.*``, a task
    head's ``classifier.*``, ``embeddings.position_ids``, layers beyond
    the model's) are ignored."""
    return copy_by_name(state, model, prefix, "HF BERT")


def load_hf_bert_params(checkpoint_path: str, model: BertEncoder
                        ) -> BertEncoder:
    """``port_bert_state_dict`` from a local checkpoint file or HF
    snapshot directory (``pretrained.torch_state_dict``), the prefix
    ``bert.`` taken when any key has it."""
    state = torch_state_dict(checkpoint_path)
    prefix = "bert." if any(k.startswith("bert.") for k in state) else ""
    return port_bert_state_dict(state, model, prefix)
