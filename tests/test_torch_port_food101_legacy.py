"""Food101's legacy pair in the port (``Food101LegacyFusionNet``: a frozen
ResNet50 and a frozen BERT with trainable heads; ``benchmarks/food101.py``'s
jprobas and jprobas_jlogits, their feed and weight loaders) against the JAX
package on the CPU.

Both model types train two steps under SGD and evaluate once through
``tests/torch_port_benchmark_harness.py`` (``food101_legacy``: the towers
narrowed through the config's keys to ``LEGACY_TINY``, the geometry of
``tests/test_food101_legacy.py``; 32 x 32 images, 16 token ids with padded
tails and a row of padding only; BERT's seven dropouts, the attention
weights' (1, 1, 16, 16) masks included, injected), whose checks are
``tests/torch_port_contract_harness.py``'s: losses to 1e-5 relative, the
heads' updates and momentum to 3e-4 of their largest entry, BN running
statistics to 1e-4 relative, the frozen leaves bit-unchanged with no
momentum on both sides.  Only the heads get a gradient, so no ReLU or
max-pool threshold enters it: numpy data seed 0 as every benchmark's.  The
twin's and the disk files' gathers (WordPiece and the crc32 fallback) and
both loaders are bit-equal to the JAX package's.  BERT alone:
``test_torch_port_bert.py``; the CLI: ``test_torch_port_food101_legacy_cli.py``.
"""

import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.benchmarks import food101 as jax_food101
from multimodal_clinical_tpu.data import food101_legacy as jax_legacy
from multimodal_clinical_tpu.models.torch_port import (
    port_bert, port_bottleneck_encoder,
)
from multimodal_clinical_tpu_torch.benchmarks import disk_fixture, food101
from multimodal_clinical_tpu_torch.data import food101_legacy
from multimodal_clinical_tpu_torch.engine.state import create_train_state
from multimodal_clinical_tpu_torch.models.jax_weights import (
    load_jax_variables,
)
from torch_port_benchmark_harness import (
    LEGACY_TINY, _args, gather_equal, run_pair, spec_equal_jax,
)
from torch_port_contract_harness import (
    B, check_eval, check_qmf_tables, check_state, check_train_metrics,
)

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False

TYPES = food101.LEGACY_TYPES
BENCH = "food101_legacy"
WIDTH, L = LEGACY_TINY["legacy_bert_width"], LEGACY_TINY["max_seq_len"]
# BERT's draws a step in flax's order: the embeddings', then per layer the
# attention weights' (one mask for the batch and every head), the attention
# output's and the FFN output's
DRAWS = [((B, L, WIDTH), 0.9)] + [
    ((1, 1, L, L), 0.9), ((B, L, WIDTH), 0.9), ((B, L, WIDTH), 0.9)
] * LEGACY_TINY["legacy_bert_layers"]
FROZEN = ("x1_model.features", "x2_model.model")


@pytest.fixture(scope="module")
def runs():
    return {t: run_pair(BENCH, t) for t in TYPES}


@pytest.mark.parametrize("model_type", TYPES)
def test_spec_equals_jax(model_type):
    spec_equal_jax(BENCH, model_type)
    args = _args(BENCH, model_type)
    spec, _ = food101.get_model_spec(args, n_train=4)
    jspec, _ = jax_food101.get_model_spec(args, n_train=4)
    assert spec.frozen_prefixes == tuple(
        p.replace("/", ".") for p in jspec.frozen_prefixes) == FROZEN
    assert (spec.contract, spec.sched_step_size, spec.sched_gamma) == (
        "jprobas", 500, 0.75)
    assert spec.eval_fusion == ("logits" if model_type == "jprobas_jlogits"
                                else None)


@pytest.mark.parametrize("model_type", TYPES)
def test_two_steps_and_eval_match_jax(runs, model_type):
    run = runs[model_type]
    check_train_metrics(run)
    check_state(run)
    check_qmf_tables(run)
    check_eval(run)
    assert run["n_dropouts"] == len(DRAWS)
    assert run["dropped"]["jax"] == DRAWS
    assert run["dropped"]["port"] == DRAWS * 2
    for m, jm in zip(run["metrics"], run["jmetrics"]):
        np.testing.assert_allclose(m["train_loss"], jm["train_loss"],
                                   rtol=1e-6)


@pytest.mark.parametrize("model_type", TYPES)
def test_frozen_towers_bit_exact_and_bn_statistics_move(runs, model_type):
    """The frozen towers' parameters bit-unchanged with no gradient and no
    momentum; their BN running statistics moved in train mode (held to
    JAX's by ``check_state``); only the two heads trained."""
    run = runs[model_type]
    state, init = run["state"], run["init"]
    sd = state.model.state_dict()
    trained = set()
    for name, p in state.model.named_parameters():
        if name.startswith(FROZEN):
            assert p.grad is None and not state.optimizer.state[p], name
            assert torch.equal(sd[name], init[name]), name
        else:
            assert not torch.equal(sd[name], init[name]), name
            trained.add(name.rsplit(".", 2)[0])
    assert trained == {"x1_model", "x2_model"}
    assert set(run["grads"][0]) == {"x1_model.fc.weight", "x1_model.fc.bias",
                                    "x2_model.classifier.weight",
                                    "x2_model.classifier.bias"}
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert stats and all(not torch.equal(sd[k], init[k]) for k in stats)


def test_eval_fusions_differ_as_jax_s(runs):
    """jprobas evaluates the log of the mean softmax, jprobas_jlogits the
    mean logits: different losses from the same kind of run."""
    a, b = (runs[t]["out"]["loss"] for t in TYPES)
    ja, jb = (runs[t]["jout"]["loss"] for t in TYPES)
    assert not np.isclose(a, b) and not np.isclose(ja, jb)


def _data_args(path, **extra):
    return SimpleNamespace(data_path=str(path) + "/", num_classes=101,
                           seed=5, model_type="jprobas", **extra)


def test_twin_equals_jax(tmp_path):
    """The 128/32/32 ``food101_legacy`` twin (64 x 64 x 3 images, 32 ids),
    read in order."""
    args = _data_args(tmp_path / "none")
    got, want = food101.get_data(args), jax_food101.get_data(args)
    gather_equal(got, want)
    assert got.synthetic and got.train_sampler == "sequential"
    assert (len(got.train), len(got.val), len(got.test)) == (128, 32, 32)
    x = got.train.gather(np.arange(2))
    assert x["x1"].shape == (2, 64, 64, 3) and x["x1"].dtype == np.float32
    assert x["x2"].shape == (2, 32) and x["x2"].dtype == np.int32


@pytest.mark.parametrize("vocab", [True, False], ids=["wordpiece", "crc32"])
def test_disk_dataset_equals_jax(tmp_path, vocab):
    """``texts_{train,test}.csv`` and the JPEGs: train flips drawn per
    (seed, epoch, index), val and test both the test split, unflipped; the
    ids from ``vocab.txt`` or hashed; bit for bit as the JAX package's."""
    made = disk_fixture.build_food101_legacy_tree(str(tmp_path), 10, 6,
                                                  n_classes=4, vocab=vocab)
    args = _data_args(tmp_path, max_seq_len=L, legacy_bert_vocab=200)
    got, want = food101.get_data(args), jax_food101.get_data(args)
    assert made["rows"] == 16 and not got.synthetic
    assert isinstance(got.train, food101_legacy.Food101LegacyDiskDataset)
    assert got.val is got.test
    for epoch in (0, 1):
        for data in (got, want):
            data.train.set_epoch(epoch)
        gather_equal(got, want)
    x = got.train.gather(np.arange(10))
    assert x["x1"].shape == (10, 224, 224, 3) and x["x2"].shape == (10, L)
    assert list(x["label"]) == [0, 1, 2, 3] * 2 + [0, 1]
    assert (x["x2"][:, 0] == 2).all() == vocab  # [CLS] with the vocabulary
    assert (x["x2"] == 0).any()  # titles padded with 0


def test_split_labels_come_from_train_and_unknown_food_raises(tmp_path):
    disk_fixture.build_food101_legacy_tree(str(tmp_path), 6, 3, n_classes=3)
    with open(tmp_path / "texts_test.csv", "a") as f:
        f.write("pizza_00099.jpg,a pizza,pizza\n")
    args = _data_args(tmp_path)
    for mod in (food101_legacy, jax_legacy):
        with pytest.raises(ValueError, match="absent from texts_train.csv"):
            mod.Food101LegacyDiskDataset(str(tmp_path), "test", args)


@pytest.mark.parametrize("text", [
    "<p>Apple Pie</p> 2 cups, 3 x eggs!", "a b  c\tdone", "",
    "Crème brûlée <br/>(classic)", "  Chicken_Wings   with s sauce "])
def test_preprocess_text_equals_jax(text):
    assert food101_legacy.preprocess_text(text) == jax_legacy.preprocess_text(
        text)


@pytest.mark.parametrize("name", ["apple_pie_0001.jpg", "pho_12.jpg",
                                  "x.jpg"])
def test_class_from_filename_equals_jax(name):
    assert food101_legacy.class_from_filename(
        name) == jax_legacy.class_from_filename(name)


# -- the weight loaders ---------------------------------------------------------

def _legacy_state(model_type="jprobas", **extra):
    args = _args(BENCH, model_type, **extra)
    spec, opt = food101.get_model_spec(args, n_train=8)
    return args, create_train_state(spec, args, seed=0, steps_per_epoch=4,
                                    device="cpu", **opt)


@functools.lru_cache(maxsize=None)
def _jax_variables():
    """The narrowed flax legacy net's variables (numpy), one jitted init."""
    jspec, _ = jax_food101.get_model_spec(_args(BENCH, "jprobas"), n_train=8)
    variables = jax.jit(functools.partial(jspec.module.init, train=False))(
        jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32),
        np.ones((1, L), np.int32))
    return jax.tree_util.tree_map(np.asarray, variables)


class _JaxState(SimpleNamespace):
    """The fields of a flax ``TrainState`` that ``load_pretrained`` uses."""

    def replace(self, **fields):
        return _JaxState(**{**vars(self), **fields})


def _jax_loaded(args):
    """The JAX ``load_pretrained`` on the flax variables, as numpy trees."""
    variables = _jax_variables()
    out = jax_food101.load_pretrained(args, _JaxState(
        params=variables["params"], batch_stats=variables["batch_stats"]))
    return (jax.tree_util.tree_map(np.asarray, out.params),
            jax.tree_util.tree_map(np.asarray, out.batch_stats))


def _torchvision_resnet(features, seed=4):
    """A seeded torchvision-named state_dict of ``features`` with the keys
    torchvision's resnet50 adds (``fc``, ``num_batches_tracked``)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {k: torch.randn(v.shape, generator=gen) * 0.1
          for k, v in features.state_dict().items()}
    for k in list(sd):
        if k.endswith("running_var"):
            sd[k] = sd[k].abs() + 0.5
            sd[k.replace("running_var", "num_batches_tracked")] = (
                torch.tensor(7))
    sd["fc.weight"], sd["fc.bias"] = torch.randn(1000, 512), torch.zeros(1000)
    return sd


def test_resnet50_weights_load_like_jax(tmp_path):
    """``resnet50_weights``: a torchvision state_dict into the image
    tower's ``features`` by name on both sides (the JAX package through
    ``port_bottleneck_encoder``), ``fc`` dropped; the rest untouched."""
    args, state = _legacy_state()
    sd = _torchvision_resnet(state.model.x1_model.features)
    torch.save(sd, tmp_path / "resnet50.pth")
    args.resnet50_weights = str(tmp_path / "resnet50.pth")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state = food101.load_pretrained(args, state)
    got = state.model.state_dict()
    for key, value in got.items():
        if key.startswith("x1_model.features."):
            assert torch.equal(value, sd[key[len("x1_model.features."):]])
        else:
            assert torch.equal(value, before[key]), key
    params, stats = _jax_loaded(args)
    want = load_jax_variables(_legacy_state()[1].model, params, stats)
    for key, value in want.state_dict().items():
        if key.startswith("x1_model.features."):
            assert torch.equal(value, got[key]), key
    jp, js = port_bottleneck_encoder(sd, stage_sizes=(1, 1))
    np.testing.assert_array_equal(params["x1_model"]["features"]["Conv_0"][
        "kernel"], jp["Conv_0"]["kernel"])


def _hf_bert(encoder, prefix, seed=8):
    """A seeded HF-named state_dict of ``encoder`` under ``prefix``, with
    the keys the port ignores (pooler, a task head, position_ids)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {prefix + k: torch.randn(v.shape, generator=gen) * 0.1
          for k, v in encoder.state_dict().items()}
    sd[prefix + "pooler.dense.weight"] = torch.randn(WIDTH, WIDTH)
    sd[prefix + "pooler.dense.bias"] = torch.zeros(WIDTH)
    sd[prefix + "embeddings.position_ids"] = torch.arange(512)[None]
    sd["classifier.weight"] = torch.randn(9, WIDTH)
    sd["classifier.bias"] = torch.zeros(9)
    return sd


@pytest.mark.parametrize("fmt", ["bert.bin", "model.safetensors"])
@pytest.mark.parametrize("prefix", ["", "bert."])
def test_bert_weights_load_like_jax(tmp_path, prefix, fmt):
    """``bert_weights``: an HF ``BertModel`` (or ``BertFor...``, keys under
    ``bert.``) checkpoint into the text tower's encoder by name on both
    sides (the JAX package through ``port_bert``); the classifier head and
    the image tower untouched."""
    args, state = _legacy_state()
    sd = _hf_bert(state.model.x2_model.model, prefix)
    if fmt.endswith(".bin"):
        torch.save(sd, tmp_path / fmt)
    else:
        from safetensors.torch import save_file

        save_file(sd, str(tmp_path / fmt))
    args.bert_weights = str(tmp_path / fmt)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state = food101.load_pretrained(args, state)
    got = state.model.state_dict()
    for key, value in got.items():
        if key.startswith("x2_model.model."):
            want = sd[prefix + key[len("x2_model.model."):]]
            assert torch.equal(value, want), key
        else:
            assert torch.equal(value, before[key]), key
    params, stats = _jax_loaded(args)
    want = load_jax_variables(_legacy_state()[1].model, params, stats)
    for key, value in want.state_dict().items():
        if key.startswith("x2_model.model."):
            assert torch.equal(value, got[key]), key
    tree = port_bert({k: v.numpy() for k, v in sd.items()},
                     torch_prefix=prefix, num_layers=2, num_heads=4)
    np.testing.assert_array_equal(
        params["x2_model"]["model"]["layer_1"]["attention"]["out"]["kernel"],
        tree["layer_1"]["attention"]["out"]["kernel"])


def test_bert_weights_refuse_a_missing_key_or_a_wrong_shape(tmp_path):
    args, state = _legacy_state()
    sd = _hf_bert(state.model.x2_model.model, "")
    key = "encoder.layer.1.output.LayerNorm.bias"
    torch.save({k: v for k, v in sd.items() if k != key}, tmp_path / "a.bin")
    args.bert_weights = str(tmp_path / "a.bin")
    with pytest.raises(KeyError, match=key):
        food101.load_pretrained(args, state)
    sd["embeddings.word_embeddings.weight"] = torch.zeros(199, WIDTH)
    torch.save(sd, tmp_path / "b.bin")
    args.bert_weights = str(tmp_path / "b.bin")
    with pytest.raises(ValueError, match="word_embeddings"):
        food101.load_pretrained(args, state)


def test_resnet50_weights_refuse_a_wrong_shape(tmp_path):
    args, state = _legacy_state()
    sd = _torchvision_resnet(state.model.x1_model.features)
    sd["layer2.0.conv2.weight"] = torch.zeros(3, 3, 3, 3)
    torch.save(sd, tmp_path / "r.pth")
    args.resnet50_weights = str(tmp_path / "r.pth")
    with pytest.raises(ValueError, match="layer2.0.conv2.weight"):
        food101.load_pretrained(args, state)
