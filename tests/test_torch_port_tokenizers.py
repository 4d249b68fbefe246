"""The port's own copies of the tokenizers (``data/wordpiece.py`` and
``data/spm.py``) against the JAX package's, bit for bit, on vocabularies
and SentencePiece models the tests write: the same ids (dtype, shape,
padding, truncation) for every text of a corpus with punctuation,
accents, CJK, unknown words and words longer than WordPiece's 100
characters, and the same loader gates."""

import numpy as np
import pytest

from multimodal_clinical_tpu.data import spm as jax_spm
from multimodal_clinical_tpu.data import wordpiece as jax_wordpiece
from multimodal_clinical_tpu_torch.benchmarks import disk_fixture
from multimodal_clinical_tpu_torch.data import spm, wordpiece
from test_spm import PIECES, serialize_model

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "quick",
         "brown", "fox", "jump", "##s", "##ed", "##ing", "over", "lazy",
         "dog", ",", ".", "!", "un", "##aff", "##able", "run", "cafe", "中",
         "'", "news", "##letter"]
TEXTS = [
    "", "The quick, brown FOX jumps over the lazy dog!",
    "unaffable runs... café CAFÉ naïve", "中文 news中 newsletter's",
    "x" * 150, "Jumped\tjumping\nover  the   dogs?!", "zebra's 42 % $",
    "the " * 80,
]


@pytest.fixture(scope="module")
def vocab_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n")
    return str(path)


@pytest.mark.parametrize("text", TEXTS)
def test_basic_tokenize_equals_jax(text):
    assert wordpiece.basic_tokenize(text) == jax_wordpiece.basic_tokenize(
        text)


@pytest.mark.parametrize("max_len", [2, 8, 64])
def test_wordpiece_encode_equals_jax(vocab_path, max_len):
    got = wordpiece.WordPieceTokenizer(vocab_path)
    want = jax_wordpiece.WordPieceTokenizer(vocab_path)
    for text in TEXTS:
        a, b = got.encode(text, max_len), want.encode(text, max_len)
        assert a.dtype == b.dtype == np.int32 and a.shape == (max_len,)
        np.testing.assert_array_equal(a, b, err_msg=text)
    assert (got.cls_id, got.sep_id, got.pad_id, got.unk_id) == (
        want.cls_id, want.sep_id, want.pad_id, want.unk_id)


def test_wordpiece_on_the_fakenews_fixture_vocab(tmp_path):
    """The vocabulary ``disk_fixture.build_fakenews_tree`` writes, over
    its titles: both packages' ``load_tokenizer`` find it under
    ``data_path`` and encode alike."""
    disk_fixture.build_fakenews_tree(str(tmp_path), 12, 3, 3, distinct=2)
    args = type("A", (), {"data_path": str(tmp_path)})()
    got, want = (wordpiece.load_tokenizer(args),
                 jax_wordpiece.load_tokenizer(args))
    assert got is not None and want is not None
    titles = [line.split("\t")[1] for line in
              (tmp_path / "train.tsv").read_text().splitlines()[1:]]
    for text in titles:
        np.testing.assert_array_equal(got.encode(text, 16),
                                      want.encode(text, 16), err_msg=text)


def test_load_tokenizer_gates_equal_jax(tmp_path, vocab_path):
    for args in ({"data_path": str(tmp_path)},
                 {"data_path": str(tmp_path), "bert_vocab_path": vocab_path},
                 {"bert_vocab_path": str(tmp_path / "missing.txt")}):
        ns = type("A", (), args)()
        got, want = wordpiece.load_tokenizer(ns), jax_wordpiece.load_tokenizer(
            ns)
        assert (got is None) == (want is None), args


@pytest.fixture(scope="module")
def models():
    blob = serialize_model(PIECES)
    return spm.SentencePieceModel.from_bytes(blob), \
        jax_spm.SentencePieceModel.from_bytes(blob)


def test_spm_proto_reader_equals_jax(models):
    got, want = models
    assert got.pieces == want.pieces
    assert (got.unk_id, got.bos_id, got.eos_id, got.pad_id) == (
        want.unk_id, want.bos_id, want.eos_id, want.pad_id)
    assert got.unk_score == want.unk_score


@pytest.mark.parametrize("text", TEXTS + ["the cat sat", "thedogs  cats",
                                          "The... cat!!"])
def test_spm_encode_equals_jax(models, text):
    got, want = models
    assert got.encode(text) == want.encode(text)
    assert got.canonicalize_text(text) == want.canonicalize_text(text)
    np.testing.assert_array_equal(got.encode_siglip(text, max_len=8),
                                  want.encode_siglip(text, max_len=8))


def test_load_spm_gates_equal_jax(tmp_path):
    args = type("A", (), {"data_path": str(tmp_path)})()
    assert spm.load_spm(args) is None and jax_spm.load_spm(args) is None
    (tmp_path / "spiece.model").write_bytes(serialize_model(PIECES))
    got, want = spm.load_spm(args), jax_spm.load_spm(args)
    assert got.encode("the dog") == want.encode("the dog") == [4, 10]
