"""Fusion networks (port of ``multimodal_clinical_tpu/models/zoo.py``):
``CremadFusionNet``, ``AVMnistFusionNet``, ``MimicFusionNet``,
``MustardFusionNet``, ``EnricoFusionNet``, ``EnricoVGGFusionNet``,
``FakeNewsFusionNet`` (with its ``TextTransformer``),
``FakeNewsEmbedFusionNet``, ``Food101FusionNet`` and
``Food101LegacyFusionNet``.  ``forward(*modality_inputs)`` returns
``{"logits": [per-modality (B, C) logits]}``; fusion and losses live in
``engine/contracts.py``.  The towers are ``x1_model``, ``x2_model``, ...
(the reference's attribute contract, which OGM-GE and the metrics
address)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import (
    Dropout, TorchDense, draw_keep, global_avg_pool, lecun_normal_,
)
from .lenet import LeNet
from .mlp import HeadMLP, MimicMLP
from .pretrained import ResNet18Slim, VGG11Slim
from .resnet import BottleneckResNetEncoder, ResNetEncoder
from .rnn import GRUNet, LstmClassifier


class CremadFusionNet(nn.Module):
    """Scratch ResNet18 audio + visual for Crema-D / AVE / VGGSound
    (cremad/joint_model.py:14-60).

    x1: (B, F, T, 1) log-spectrogram; x2: (B, T, H, W, 3) frames.  Time is
    folded into the batch for the visual tower (backbone.py:178-181) and
    pooled jointly with space afterwards (joint_model.py:43-50).  ``width``
    is the stem width of both towers (64 in the reference; the tests narrow
    it).  ``pool_kernel``, ``remat`` and ``stem_space_to_depth`` are the
    towers' switches (see ``ResNetEncoder``).
    """

    def __init__(self, num_classes: int, dtype: Optional[torch.dtype] = None,
                 width: int = 64, pool_kernel: str = "xla",
                 remat: Optional[str] = None,
                 stem_space_to_depth: bool = False):
        super().__init__()
        switches = dict(width=width, dtype=dtype, pool_kernel=pool_kernel,
                        remat=remat, stem_space_to_depth=stem_space_to_depth)
        self.x1_model = ResNetEncoder(1, **switches)
        self.x2_model = ResNetEncoder(3, **switches)
        self.x1_classifier = TorchDense(8 * width, num_classes, dtype)
        self.x2_classifier = TorchDense(8 * width, num_classes, dtype)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor):
        a = global_avg_pool(self.x1_model(x1))                 # (B, 8w)
        b, t = x2.shape[:2]
        v = self.x2_model(x2.flatten(0, 1))                    # (B*T, h, w, 8w)
        v = v.unflatten(0, (b, t)).mean(dim=(1, 2, 3))         # over (T, h, w)
        return {"logits": [self.x1_classifier(a), self.x2_classifier(v)]}


class AVMnistFusionNet(nn.Module):
    """LeNet pair for AV-MNIST (avmnist/joint_model.py:101-130).

    x1: (B, 28, 28, 1) image; x2: (B, 112, 112, 1) spectrogram.  The
    reference applies ReLU to each encoder's output before its head.
    """

    def __init__(self, num_classes: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.x1_model = LeNet(1, 6, 3, dtype)
        self.x2_model = LeNet(1, 6, 5, dtype)
        self.classifier_x1 = TorchDense(self.x1_model.out_features,
                                        num_classes, dtype)
        self.classifier_x2 = TorchDense(self.x2_model.out_features,
                                        num_classes, dtype)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor):
        h1 = F.relu(self.x1_model(x1))
        h2 = F.relu(self.x2_model(x2))
        return {"logits": [self.classifier_x1(h1), self.classifier_x2(h2)]}


class MimicFusionNet(nn.Module):
    """MLP (static 5-dim) + GRU (24 x 12 time series) for MIMIC
    (mimic/joint_model.py:72-125)."""

    def __init__(self, num_classes: int, gru_hidden_dim: int = 32,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.x1_model = MimicMLP(num_classes, dtype=dtype)
        self.x2_model = GRUNet(12, gru_hidden_dim, num_classes, dtype)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor):
        return {"logits": [self.x1_model(x1), self.x2_model(x2)]}


class MustardFusionNet(nn.Module):
    """Three LstmClassifiers (vision 371 / audio 81 / text 300 GloVe) for
    MUsTARD (mustard/joint_model.py:45-83)."""

    def __init__(self, num_classes: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        for i, f in enumerate((371, 81, 300)):
            self.add_module(f"x{i + 1}_model",
                            LstmClassifier(f, num_classes, dtype=dtype))

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, x3: torch.Tensor):
        return {"logits": [self.x1_model(x1), self.x2_model(x2),
                           self.x3_model(x3)]}


class EnricoFusionNet(nn.Module):
    """ResNet18Slim pair for Enrico (enrico/joint_model.py:54-77):
    screenshot x1 and wireframe x2, each (B, H, W, 3).  ``freeze_features``
    is True for the joint model and False for the ensemble
    (enrico/ensemble_model.py); the embeddings feed the VICReg variant
    (enrico/ensemble_model_vicreg.py:103-111).  ``width``: the towers'
    stem width (see ``ResNet18Slim``)."""

    def __init__(self, num_classes: int, freeze_features: bool = True,
                 dtype: Optional[torch.dtype] = None, width: int = 64):
        super().__init__()
        self.x1_model = ResNet18Slim(num_classes, freeze_features, dtype,
                                     width)
        self.x2_model = ResNet18Slim(num_classes, freeze_features, dtype,
                                     width)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor):
        e1, l1 = self.x1_model(x1)
        e2, l2 = self.x2_model(x2)
        return {"logits": [l1, l2], "embeddings": [e1, e2]}


class EnricoVGGFusionNet(nn.Module):
    """VGG11Slim pair (enrico/joint_model_counts.py:58-), the analysis
    variant."""

    def __init__(self, num_classes: int, freeze_features: bool = True,
                 dropout_p: float = 0.2, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.x1_model = VGG11Slim(num_classes, dropout_p=dropout_p,
                                  freeze_features=freeze_features,
                                  dtype=dtype)
        self.x2_model = VGG11Slim(num_classes, dropout_p=dropout_p,
                                  freeze_features=freeze_features,
                                  dtype=dtype)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor):
        return {"logits": [self.x1_model(x1), self.x2_model(x2)]}


class Dense(TorchDense):
    """flax ``nn.Dense``: torch's (out, in) layout, flax's init
    (lecun-normal kernel, zero bias)."""

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        nn.init.zeros_(self.bias)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` with its defaults (eps 1e-6, ``dtype`` None):
    the statistics in at least fp32, the variance as E[x^2] - E[x]^2
    clipped at 0, y = (x - mean) * (rsqrt(var + eps) * scale) + bias, and
    the output in the promotion of the input with the fp32 parameters (a
    bf16 input gives fp32)."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator=None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(x.dtype, torch.float32)
        x = x.to(dtype)
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.weight.to(dtype))
        return y + self.bias.to(dtype)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          dropout_rate: float = 0.0) -> torch.Tensor:
    """flax's ``dot_product_attention`` (0.12) on (B, L, H, d) heads,
    written out as its products and softmax: the query scaled by
    1 / sqrt(d) before q.k, masked logits set to the dtype's lowest finite
    value (so a row with nothing to attend to attends uniformly, where
    -inf masking gives NaN), the softmax in the inputs' dtype.  ``mask``
    broadcasts to (B, H, Lq, Lk), True where a key is attended.  A
    ``dropout_rate`` above 0 drops attention weights after the softmax as
    flax's ``broadcast_dropout`` does: one (1, 1, Lq, Lk) keep mask
    (``common.draw_keep``) for the whole batch and every head, applied as
    ``weights * (keep / keep_prob)`` in the weights' dtype."""
    depth = q.shape[-1]
    # jnp.sqrt(depth) in fp32, cast to the compute dtype
    q = q / torch.tensor(math.sqrt(depth), dtype=torch.float32).to(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    weights = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0:
        keep_prob = 1.0 - dropout_rate
        keep = draw_keep((1, 1) + tuple(weights.shape[-2:]), keep_prob,
                         weights.device)
        weights = weights * (keep.to(weights.dtype) / torch.tensor(
            keep_prob, dtype=weights.dtype))
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (0.12): queries from
    ``inputs_q``, keys and values from ``inputs_kv`` (``inputs_q`` where
    None), ``dot_product_attention`` over ``num_heads`` heads, then the
    output projection.  ``names`` are the four projections' module names
    (query, key, value, out), each a ``Dense`` holding flax's (D, H, d) or
    (H, d, D) kernel in the torch (out, in) layout: flax's own by default,
    HF's ``q_proj``/``k_proj``/``v_proj``/``out_proj`` for SigLIP; a
    subclass that packs the first three (``siglip.PackedAttention``)
    names them None and overrides ``project``; with the out name None
    (BERT, whose output projection HF keeps under another parent) the
    caller projects ``attend``'s heads itself.  ``dropout_rate`` drops
    attention weights in train mode (flax's ``dropout_rate``; 0 by
    default)."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: Optional[torch.dtype] = None,
                 names: Sequence[str] = ("query", "key", "value", "out"),
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.num_heads = num_heads
        self.names = tuple(names)
        self.dropout_rate = float(dropout_rate)
        for name in self.names:
            if name is not None:
                self.add_module(name, Dense(dim, dim, dtype))

    def project(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """The query (0), key (1) or value (2) projection of x."""
        return getattr(self, self.names[i])(x)

    def attend(self, inputs_q: torch.Tensor,
               inputs_kv: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, Lq, D), (B, Lk, D) -> the heads (B, Lq, H * d), before the
        output projection."""
        inputs_kv = inputs_q if inputs_kv is None else inputs_kv
        q, k, v = (self.project(i, x).unflatten(-1, (self.num_heads, -1))
                   for i, x in enumerate((inputs_q, inputs_kv, inputs_kv)))
        rate = self.dropout_rate if self.training else 0.0
        return dot_product_attention(q, k, v, mask, rate).flatten(-2)

    def forward(self, inputs_q: torch.Tensor,
                inputs_kv: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, Lq, D), (B, Lk, D) -> (B, Lq, D)."""
        return getattr(self, self.names[3])(self.attend(inputs_q, inputs_kv,
                                                        mask))


class SelfAttention(MultiHeadDotProductAttention):
    """Self-attention under a key-padding mask, FakeNews's
    ``TextTransformer`` layer."""

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x (B, L, D); mask (B, L), True where a token is real."""
        return super().forward(x, mask=mask[:, None, None, :])


class TextTransformer(nn.Module):
    """Small pre-LN transformer text encoder over token ids (id 0 is
    padding, masked), mean-pooled over the real tokens: (B, L) ->
    (B, embed_dim).  The embedding gathers in ``dtype``, the position
    table is cast to the embedding's dtype, the layer norms give fp32,
    the MLP's GELU is the tanh approximation (flax ``nn.gelu``).  The
    FakeNews text towers."""

    def __init__(self, vocab_size: int = 30522, embed_dim: int = 256,
                 num_heads: int = 4, num_layers: int = 2, max_len: int = 512,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.num_layers = num_layers
        self.max_len = max_len
        self.embedding = nn.Parameter(torch.empty(vocab_size, embed_dim))
        self.pos = nn.Parameter(torch.empty(1, max_len, embed_dim))
        for i in range(num_layers):
            self.add_module(f"ln1_{i}", LayerNorm(embed_dim))
            self.add_module(f"attn_{i}", SelfAttention(embed_dim, num_heads,
                                                       dtype))
            self.add_module(f"ln2_{i}", LayerNorm(embed_dim))
            self.add_module(f"mlp1_{i}", Dense(embed_dim, 4 * embed_dim,
                                               dtype))
            self.add_module(f"mlp2_{i}", Dense(4 * embed_dim, embed_dim,
                                               dtype))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        # flax's default Embed init, N(0, 1 / embed_dim); pos N(0, 0.02)
        nn.init.normal_(self.embedding, 0.0,
                        1.0 / math.sqrt(self.embedding.shape[1]),
                        generator=generator)
        nn.init.normal_(self.pos, 0.0, 0.02, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if ids.shape[1] > self.max_len:
            raise ValueError(
                f"sequence length {ids.shape[1]} > max_len {self.max_len}")
        emb = F.embedding(ids, self.embedding)
        if self.dtype is not None:
            emb = emb.to(self.dtype)
        h = emb + self.pos[:, :ids.shape[1]].to(emb.dtype)
        mask = ids != 0
        for i in range(self.num_layers):
            h = h + getattr(self, f"attn_{i}")(getattr(self, f"ln1_{i}")(h),
                                               mask)
            mlp = getattr(self, f"mlp1_{i}")(getattr(self, f"ln2_{i}")(h))
            h = h + getattr(self, f"mlp2_{i}")(F.gelu(mlp,
                                                      approximate="tanh"))
        denom = mask.sum(-1, keepdim=True).clamp_min(1)
        return (h * mask[..., None].to(h.dtype)).sum(1) / denom


class FakeNewsFusionNet(nn.Module):
    """Text + image (+ dialogue) late fusion for Fakeddit, the JAX
    package's completion of the design the reference left broken
    (fakenews/run_training.py:42-44): a ``TextTransformer`` over token ids
    (x1), a scratch ResNet18 over (B, H, W, 3) images (x2), and with
    ``with_dialogue`` a second ``TextTransformer`` over the
    summarised-comment ids (x3), each with its own ``TorchDense`` head.
    ``width`` is the image tower's stem width (64 in the JAX package; the
    tests narrow it)."""

    def __init__(self, num_classes: int, vocab_size: int = 30522,
                 embed_dim: int = 256, num_heads: int = 4,
                 num_layers: int = 2, with_dialogue: bool = False,
                 dtype: Optional[torch.dtype] = None, width: int = 64):
        super().__init__()
        common = dict(vocab_size=vocab_size, embed_dim=embed_dim,
                      num_heads=num_heads, num_layers=num_layers, dtype=dtype)
        self.x1_model = TextTransformer(**common)
        self.x1_classifier = TorchDense(embed_dim, num_classes, dtype)
        self.x2_model = ResNetEncoder(3, width=width, dtype=dtype)
        self.x2_classifier = TorchDense(8 * width, num_classes, dtype)
        self.with_dialogue = with_dialogue
        if with_dialogue:
            self.x3_model = TextTransformer(**common)
            self.x3_classifier = TorchDense(embed_dim, num_classes, dtype)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                x3: Optional[torch.Tensor] = None):
        logits = [self.x1_classifier(self.x1_model(x1)),
                  self.x2_classifier(global_avg_pool(self.x2_model(x2)))]
        if self.with_dialogue:
            logits.append(self.x3_classifier(self.x3_model(x3)))
        return {"logits": logits}


class FakeNewsEmbedFusionNet(nn.Module):
    """The reference's one runnable FakeNews architecture: concat fusion
    over precomputed sentence-transformer embeddings (fakenews/model.py:
    34-148, ``_build_model`` 234-257).  relu(Linear(768 -> 300)) on the
    text embedding x1; a Bottleneck ResNet152 on the (B, H, W, 3) image x2
    with relu(Linear(2048 -> 300)); with ``with_dialogue`` relu(Linear(768
    -> 300)) on the dialogue embedding x3; then concat -> dropout(relu(
    Linear(-> 512))) -> relu(fc1) -> fc2: one fused logits head, which the
    spec trains as jlogits with ``num_modality=1``.  ``image_stage_sizes``
    shrinks the image tower for tests."""

    def __init__(self, num_classes: int, embedding_dim: int = 768,
                 text_feature_dim: int = 300, image_feature_dim: int = 300,
                 dialogue_feature_dim: int = 300,
                 fusion_output_size: int = 512, hidden_size: int = 512,
                 dropout_p: float = 0.1, with_dialogue: bool = False,
                 image_stage_sizes: Sequence[int] = (3, 8, 36, 3),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.with_dialogue = with_dialogue
        self.text_module = TorchDense(embedding_dim, text_feature_dim, dtype)
        self.image_module = BottleneckResNetEncoder(
            3, tuple(image_stage_sizes), dtype=dtype)
        self.image_fc = TorchDense(self.image_module.out_features,
                                   image_feature_dim, dtype)
        fused_in = text_feature_dim + image_feature_dim
        if with_dialogue:
            self.dialogue_module = TorchDense(embedding_dim,
                                              dialogue_feature_dim, dtype)
            fused_in += dialogue_feature_dim
        self.fusion = TorchDense(fused_in, fusion_output_size, dtype)
        self.dropout = Dropout(dropout_p)
        self.fc1 = TorchDense(fusion_output_size, hidden_size, dtype)
        self.fc2 = TorchDense(hidden_size, num_classes, dtype)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                x3: Optional[torch.Tensor] = None):
        if x1.shape[-1] != self.embedding_dim:
            raise ValueError(
                f"text embedding dim {x1.shape[-1]} != configured "
                f"embedding_dim {self.embedding_dim} (text_embed_dim key)")
        parts = [F.relu(self.text_module(x1)),
                 F.relu(self.image_fc(global_avg_pool(
                     self.image_module(x2))))]
        if self.with_dialogue:
            parts.append(F.relu(self.dialogue_module(x3)))
        fused = self.dropout(F.relu(self.fusion(torch.cat(parts, dim=-1))))
        return {"logits": [self.fc2(F.relu(self.fc1(fused)))]}


class Food101FusionNet(nn.Module):
    """The SigLIP dual tower and two ``HeadMLP`` heads for Food101
    (food101/joint_model.py:26-66): ``model`` is the whole SigLIP (fully
    trainable, as the reference's ``AutoModel``), ``x1_model`` the text
    head and ``x2_model`` the image head, so OGM-GE finds no 4-D leaf under
    the heads and modulates nothing (food101/joint_model_ogm_ge.py).

    x1: (B, L) int token ids; x2: (B, H, W, 3) pixel values.
    ``pipeline_stages``, ``pipeline_microbatches``, ``sequence_sharding``
    and ``mesh`` are SigLIP's scaling switches (``models/siglip.py``)."""

    def __init__(self, num_classes: int, dtype: Optional[torch.dtype] = None,
                 pipeline_stages: int = 0, pipeline_microbatches: int = 4,
                 sequence_sharding: bool = False, mesh=None):
        super().__init__()
        # siglip.py builds on this module's attention and layer norm; the
        # name is looked up here, as the JAX net looks it up in __call__
        from . import siglip

        self.model = siglip.SigLIPModel(
            dtype=dtype, pipeline_stages=pipeline_stages,
            pipeline_microbatches=pipeline_microbatches,
            sequence_sharding=sequence_sharding, mesh=mesh)
        width = self.model.text_model.head.weight.shape[0]
        self.x1_model = HeadMLP(num_classes, width, dtype=dtype)
        self.x2_model = HeadMLP(num_classes, width, dtype=dtype)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor):
        text, image = self.model(x1, x2)
        return {"logits": [self.x1_model(text), self.x2_model(image)]}


class LegacyImageTower(nn.Module):
    """torchvision resnet50 without its fc (``features``, frozen: run
    under ``torch.no_grad()``), the global average pool and a fresh
    trainable ``fc``: (B, H, W, 3) -> (B, C)."""

    def __init__(self, num_classes: int, stage_sizes: Sequence[int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.features = BottleneckResNetEncoder(3, tuple(stage_sizes),
                                                dtype=dtype)
        self.fc = TorchDense(self.features.out_features, num_classes, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            emb = global_avg_pool(self.features(x))
        return self.fc(emb)


class Food101LegacyFusionNet(nn.Module):
    """Food101's legacy towers (food101/joint_model_proba_logits.py:30-90):
    a frozen torchvision-resnet50 image tower with a fresh trainable
    ``fc`` (``x1_model``) and a frozen BERT-base text tower with a
    trainable [CLS] ``classifier`` (``x2_model``).  x1: (B, 224, 224, 3)
    image; x2: (B, L) int bert-base-uncased token ids (pad 0): the
    opposite modality order of the SigLIP family.

    The frozen parts run under ``torch.no_grad()`` (the JAX package's
    ``stop_gradient``); in train mode their BN still normalises with batch
    statistics and updates its running statistics, and their dropouts
    still draw: the reference never calls ``.eval()`` on them.  The
    geometry shrinks for tests; the defaults are the real towers."""

    def __init__(self, num_classes: int,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 bert_layers: int = 12, bert_width: int = 768,
                 bert_heads: int = 12, bert_vocab: int = 30522,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        from .bert import BertClassifier

        self.x1_model = LegacyImageTower(num_classes, stage_sizes, dtype)
        self.x2_model = BertClassifier(
            num_classes, freeze_backbone=True, num_layers=bert_layers,
            width=bert_width, heads=bert_heads, vocab_size=bert_vocab,
            dtype=dtype)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor):
        return {"logits": [self.x1_model(x1), self.x2_model(x2)]}
