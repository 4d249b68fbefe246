"""Self-contained SentencePiece **unigram** encoder (SigLIP text front-end);
the port's own copy of ``multimodal_clinical_tpu/data/spm.py``.

Replaces the reference's HF ``AutoTokenizer`` dependency for Food101 token
extraction (food101/extract_token.py:45-69 pads SigLIP ids to 64) in a
zero-egress environment: given a LOCAL ``tokenizer.model`` /
``spiece.model`` (the serialized ``sentencepiece.ModelProto``) this module

  * parses the model protobuf directly (minimal wire-format reader — no
    ``sentencepiece``/compiled-proto dependency; field numbers follow the
    public sentencepiece_model.proto: ModelProto.pieces=1 {piece=1,
    score=2, type=3}, trainer_spec=2 {model_type=3, unk_id=40, bos_id=41,
    eos_id=42, pad_id=43}, normalizer_spec=3 {add_dummy_prefix=3,
    remove_extra_whitespaces=4, escape_whitespaces=5});
  * segments text with the unigram **Viterbi** decode: maximize the sum of
    piece log-probs over the lattice, unknown characters scored
    ``min_score - 10`` (sentencepiece's kUnkPenalty) and consecutive
    unknowns fused into ONE ``<unk>`` token (sentencepiece/HF fuse_unk
    semantics);
  * reproduces the HF ``SiglipTokenizer`` request pipeline:
    ``canonicalize_text`` (strip ``string.punctuation``, collapse
    whitespace — big_vision prompt_engineering semantics), Viterbi ids,
    ``</s>`` appended, ``</s>``-padded to ``model_max_length`` 64.

Same local-artifact pattern as data/wordpiece.py (BERT).  Segmentation is
golden-tested against HF ``tokenizers``' Rust Unigram implementation and
the proto reader against hand-serialized wire bytes
(tests/test_spm.py, on the JAX package's copy; this copy is held to it
in tests/test_torch_port_tokenizers.py).

Normalization note: real SentencePiece models carry a precompiled
normalization charsmap (usually NMT-NFKC).  This module applies Python
``unicodedata.normalize("NFKC", ...)`` instead — identical for ASCII and
the overwhelming majority of text; the handful of NMT-specific control
mappings are not reproduced (documented divergence).
"""

from __future__ import annotations

import os
import re
import string
import unicodedata
from typing import Dict, List, Optional, Tuple

import numpy as np

SPIECE_UNDERLINE = "▁"
_UNK_PENALTY = 10.0  # sentencepiece unigram_model.cc kUnkPenalty

# ModelProto.SentencePiece.Type values (sentencepiece_model.proto)
_TYPE_NORMAL = 1
_TYPE_UNKNOWN = 2
_TYPE_CONTROL = 3
_TYPE_USER_DEFINED = 4
_TYPE_UNUSED = 5
_TYPE_BYTE = 6


# ---------------------------------------------------------------------------
# Minimal protobuf wire-format reader


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _signed32(v: int) -> int:
    """Plain int32 proto fields encode negatives as 64-bit two's
    complement varints."""
    v &= (1 << 64) - 1
    if v >= 1 << 63:
        v -= 1 << 64
    return v


def _iter_fields(data: bytes):
    """Yield (field_number, wire_type, value) over one message's bytes.
    LEN fields yield raw bytes; varints yield ints; 32/64-bit yield raw
    bytes."""
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(data, pos)
        elif wire == 1:  # 64-bit
            val, pos = data[pos:pos + 8], pos + 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(data, pos)
            val, pos = data[pos:pos + ln], pos + ln
        elif wire == 5:  # 32-bit
            val, pos = data[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire} (field {field})")
        yield field, wire, val


def _parse_piece(data: bytes) -> Tuple[str, float, int]:
    piece, score, ptype = "", 0.0, _TYPE_NORMAL
    for field, _wire, val in _iter_fields(data):
        if field == 1:
            piece = val.decode("utf-8")
        elif field == 2:
            score = float(np.frombuffer(val, "<f4")[0])
        elif field == 3:
            ptype = int(val)
    return piece, score, ptype


class SentencePieceModel:
    """Parsed unigram model + Viterbi encoder."""

    def __init__(self, pieces: List[Tuple[str, float, int]],
                 unk_id: int = 0, bos_id: int = 1, eos_id: int = 2,
                 pad_id: int = -1, add_dummy_prefix: bool = True,
                 remove_extra_whitespaces: bool = True,
                 escape_whitespaces: bool = True):
        self.pieces = pieces
        self.unk_id = unk_id
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.add_dummy_prefix = add_dummy_prefix
        self.remove_extra_whitespaces = remove_extra_whitespaces
        self.escape_whitespaces = escape_whitespaces
        # matchable vocab: NORMAL + USER_DEFINED pieces only
        self.vocab: Dict[str, Tuple[int, float]] = {}
        scores = []
        for i, (piece, score, ptype) in enumerate(pieces):
            if ptype in (_TYPE_NORMAL, _TYPE_USER_DEFINED):
                self.vocab[piece] = (i, score)
                scores.append(score)
        if not self.vocab:
            raise ValueError("model has no matchable pieces")
        self.max_piece_len = max(len(p) for p in self.vocab)
        self.unk_score = min(scores) - _UNK_PENALTY

    # -- construction -------------------------------------------------------

    @classmethod
    def from_bytes(cls, data: bytes) -> "SentencePieceModel":
        pieces: List[Tuple[str, float, int]] = []
        kw = {}
        for field, _wire, val in _iter_fields(data):
            if field == 1:  # pieces
                pieces.append(_parse_piece(val))
            elif field == 2:  # trainer_spec
                names = {40: "unk_id", 41: "bos_id", 42: "eos_id",
                         43: "pad_id"}
                for f2, w2, v2 in _iter_fields(val):
                    if f2 in names and w2 == 0:
                        kw[names[f2]] = _signed32(v2)
                    elif f2 == 3 and w2 == 0 and int(v2) != 1:
                        raise ValueError(
                            f"model_type {v2} is not UNIGRAM(1); only "
                            "unigram models are supported")
            elif field == 3:  # normalizer_spec
                names = {3: "add_dummy_prefix",
                         4: "remove_extra_whitespaces",
                         5: "escape_whitespaces"}
                for f2, w2, v2 in _iter_fields(val):
                    if f2 in names and w2 == 0:
                        kw[names[f2]] = bool(v2)
        return cls(pieces, **kw)

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceModel":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    # -- encoding -----------------------------------------------------------

    def normalize(self, text: str) -> str:
        """NFKC (see module docstring), optional whitespace collapse,
        space -> ▁ escaping, optional dummy prefix."""
        text = unicodedata.normalize("NFKC", text)
        if self.remove_extra_whitespaces:
            text = re.sub(r"\s+", " ", text).strip()
        if self.add_dummy_prefix and text:
            text = " " + text
        if self.escape_whitespaces:
            text = text.replace(" ", SPIECE_UNDERLINE)
        return text

    def _viterbi(self, s: str) -> List[int]:
        """Best segmentation of the normalized string: ids, consecutive
        unknown characters fused into one unk_id."""
        n = len(s)
        if n == 0:
            return []
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)
        best[0] = 0.0
        for end in range(1, n + 1):
            lo = max(0, end - self.max_piece_len)
            for start in range(lo, end):
                if best[start] == NEG:
                    continue
                hit = self.vocab.get(s[start:end])
                if hit is not None and best[start] + hit[1] > best[end]:
                    best[end] = best[start] + hit[1]
                    back[end] = (start, hit[0])
            # single-char unknown fallback
            if best[end - 1] != NEG \
                    and best[end - 1] + self.unk_score > best[end]:
                best[end] = best[end - 1] + self.unk_score
                back[end] = (end - 1, self.unk_id)
        ids: List[int] = []
        pos = n
        while pos > 0:
            start, pid = back[pos]
            ids.append(pid)
            pos = start
        ids.reverse()
        # fuse runs of unknowns (sentencepiece/HF fuse_unk)
        fused: List[int] = []
        for pid in ids:
            if pid == self.unk_id and fused and fused[-1] == self.unk_id:
                continue
            fused.append(pid)
        return fused

    def encode(self, text: str) -> List[int]:
        return self._viterbi(self.normalize(text))

    # -- SigLIP request pipeline ---------------------------------------------

    @staticmethod
    def canonicalize_text(text: str) -> str:
        """HF SiglipTokenizer.canonicalize_text (big_vision
        prompt_engineering.py): strip ``string.punctuation``, collapse
        whitespace, strip."""
        text = text.translate(str.maketrans("", "", string.punctuation))
        return re.sub(r"\s+", " ", text).strip()

    def encode_siglip(self, text: str, max_len: int = 64) -> np.ndarray:
        """ids the reference's extract_token.py stores: canonicalized
        text, ``</s>`` (eos) appended, ``</s>``-padded to ``max_len``
        (SiglipTokenizer: pad_token == eos_token == "</s>",
        padding="max_length", truncation=True)."""
        ids = self.encode(self.canonicalize_text(text))
        pad = self.pad_id if self.pad_id >= 0 else self.eos_id
        ids = ids[: max_len - 1] + [self.eos_id]
        ids = ids + [pad] * (max_len - len(ids))
        return np.asarray(ids, np.int32)


def load_spm(args) -> Optional[SentencePieceModel]:
    """SentencePieceModel from ``args.spm_model_path`` or
    ``<data_path>/{tokenizer,spiece}.model``; None when no local model
    exists (same zero-egress gate as data/wordpiece.load_tokenizer)."""
    candidates = []
    explicit = getattr(args, "spm_model_path", None)
    if explicit:
        candidates.append(str(explicit))
    data_path = getattr(args, "data_path", None)
    if data_path:
        candidates.append(os.path.join(str(data_path), "tokenizer.model"))
        candidates.append(os.path.join(str(data_path), "spiece.model"))
    for path in candidates:
        if os.path.isfile(path):
            return SentencePieceModel.from_file(path)
    return None
