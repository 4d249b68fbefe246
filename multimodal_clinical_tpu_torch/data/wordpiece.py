"""Self-contained WordPiece tokenizer (bert-base-uncased semantics); the
port's own copy of ``multimodal_clinical_tpu/data/wordpiece.py``.

Replaces the reference's at-runtime HF download
(fakenews/get_data.py:175-189, food101/get_data_old.py:15) in a zero-egress
environment: given a local ``vocab.txt`` this reproduces
``BertTokenizer(do_lower_case=True)`` — basic tokenization (lowercase,
accent stripping, punctuation splitting) followed by greedy longest-match
WordPiece with ``##`` continuations, [CLS]/[SEP] framing, truncation and
[PAD]-0 padding.  Cross-checked against ``BertTokenizerFast`` in
tests/test_wordpiece.py (the JAX package's copy) and against that copy in
tests/test_torch_port_tokenizers.py.
"""

from __future__ import annotations

import os
import unicodedata
from typing import List, Optional

import numpy as np

_MAX_WORD_CHARS = 100  # HF WordpieceTokenizer max_input_chars_per_word


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    # ASCII punctuation blocks (HF treats these as punctuation even when
    # unicode category says otherwise), then the unicode P* categories
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(ch: str) -> bool:
    # HF BasicTokenizer._is_chinese_char ranges: CJK ideographs are
    # tokenized one character per token (tokenize_chinese_chars=True,
    # the bert-base-uncased default)
    cp = ord(ch)
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def basic_tokenize(text: str) -> List[str]:
    """Lowercase, strip accents, split punctuation and CJK ideographs
    into single tokens."""
    text = unicodedata.normalize("NFD", text.lower())
    out: List[str] = []
    word: List[str] = []

    def flush():
        if word:
            out.append("".join(word))
            word.clear()

    for ch in text:
        cat = unicodedata.category(ch)
        if cat == "Mn":  # combining accent mark: strip
            continue
        if ch.isspace():
            flush()
        elif _is_punct(ch) or _is_cjk(ch):
            flush()
            out.append(ch)
        elif cat.startswith("C"):  # control chars: drop
            continue
        else:
            word.append(ch)
    flush()
    return out


class WordPieceTokenizer:
    def __init__(self, vocab_path: str):
        self.vocab = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    self.vocab[tok] = i
        self.pad_id = self.vocab.get("[PAD]", 0)
        self.unk_id = self.vocab["[UNK]"]
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]

    def wordpiece(self, word: str) -> List[int]:
        """Greedy longest-match; whole word becomes [UNK] on any failure
        (BERT semantics)."""
        if len(word) > _MAX_WORD_CHARS:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str, max_len: int) -> np.ndarray:
        """[CLS] pieces [SEP], truncated so [SEP] survives, padded to
        ``max_len`` with [PAD]."""
        ids: List[int] = []
        for word in basic_tokenize(text):
            ids.extend(self.wordpiece(word))
        ids = [self.cls_id] + ids[: max_len - 2] + [self.sep_id]
        ids = ids + [self.pad_id] * (max_len - len(ids))
        return np.asarray(ids, np.int32)


def load_tokenizer(args) -> Optional[WordPieceTokenizer]:
    """WordPieceTokenizer from ``args.bert_vocab_path`` or
    ``<data_path>/vocab.txt``; None when no local vocab exists."""
    candidates = []
    explicit = getattr(args, "bert_vocab_path", None)
    if explicit:
        candidates.append(str(explicit))
    data_path = getattr(args, "data_path", None)
    if data_path:
        candidates.append(os.path.join(str(data_path), "vocab.txt"))
    for path in candidates:
        if os.path.isfile(path):
            return WordPieceTokenizer(path)
    return None
