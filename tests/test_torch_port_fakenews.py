"""FakeNews in the port (``benchmarks/fakenews.py``, ``FakeNewsFusionNet``,
``FakeNewsEmbedFusionNet``, ``lr_override`` and ``num_modality=1``)
against the JAX package on the CPU.

Every model type trains two steps under Adam and evaluates once through
``tests/torch_port_benchmark_harness.py``, whose step checks are
``tests/torch_port_contract_harness.py``'s (Adam held as there): the
token variants on 12-token rows (each padded at its tail, the second row
all padding) and 64 x 64 images with the image tower at width 16 and one
block a stage; the embed variants on 768-d embeddings and 32 x 32 images
with one Bottleneck block a stage (width 8) and their fusion dropout
injected.  The embed net's image tower is held in float64 only
(``test_torch_port_fakenews_towers.py``): its fp32 gradient parts from
JAX's by about 1% of the largest entry at the first step.  Attention's
key bias has a gradient that is zero in exact arithmetic: held to
rounding.  The disk gathers (every tokenizer) and ``load_pretrained`` are
bit-equal.  The towers: ``test_torch_port_fakenews_towers.py``; the CLI:
``test_torch_port_fakenews_cli.py``.
"""

import functools
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.benchmarks import fakenews as jax_fakenews
from multimodal_clinical_tpu_torch.benchmarks import disk_fixture, fakenews
from multimodal_clinical_tpu_torch.engine.state import create_train_state
from multimodal_clinical_tpu_torch.models.jax_weights import (
    load_jax_variables,
)
from multimodal_clinical_tpu_torch.models.resnet import (
    BottleneckResNetEncoder,
)
from torch_port_benchmark_harness import (
    _args, gather_equal, narrow, run_pair, spec_equal_jax,
)
from torch_port_contract_harness import (
    check_eval, check_qmf_tables, check_state, check_train_metrics,
)

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False

EMBED = ("jlogits_embed", "jlogits_embed_dialogue")


def _bench(model_type):
    return "fakenews_embed" if model_type in EMBED else "fakenews"


def test_model_types_are_jax_s():
    assert fakenews.MODEL_TYPES == jax_fakenews.MODEL_TYPES


@pytest.mark.parametrize("model_type", fakenews.MODEL_TYPES)
def test_spec_equals_jax(model_type):
    spec_equal_jax(_bench(model_type), model_type)


def test_unknown_model_type_raises():
    with pytest.raises(NotImplementedError, match="fakenews model_type"):
        fakenews.get_model_spec(_args("fakenews", "jprobas"), n_train=4)


@pytest.mark.parametrize("model_type", fakenews.MODEL_TYPES)
def test_two_steps_and_eval_match_jax(model_type):
    run = run_pair(_bench(model_type), model_type)
    check_train_metrics(run)
    check_state(run, rounding_grads=(".key.bias",),
                float64_only=("image_module.",))
    check_qmf_tables(run)
    check_eval(run)
    state = run["state"]
    # lr_override: Adam at 1e-4 whatever learning_rate (1e-2) says
    assert run["opt"]["lr_override"] == 1e-4
    assert [g["lr"] for g in state.optimizer.param_groups] == [1e-4]
    assert state.lr_metric_name == "lr-Adam"
    dropped = run["dropped"]
    if model_type in EMBED:
        # num_modality=1: one fused head, a (1, C) EMA
        assert run["spec"].num_modality == 1
        assert state.ema.shape == (1, 6) and state.ema.any()
        assert "train_x2_acc" not in run["metrics"][0]
        assert len(dropped["jax"]) == 1
        assert dropped["port"] == dropped["jax"] * 2
    else:
        assert dropped == {"jax": [], "port": []}
        n = 3 if model_type.endswith("dialogue") else 2
        assert f"train_x{n}_acc" in run["metrics"][0]


@pytest.mark.parametrize("use_scheduler", [False, True])
def test_lr_override_sets_the_base_rate(use_scheduler):
    """The override replaces ``learning_rate`` as the schedule's base; a
    scheduler (off in fakenews.yaml) still steps it, as in JAX."""
    from multimodal_clinical_tpu.engine.state import make_lr_schedule

    args = _args("fakenews", "jlogits", learning_rate=0.5, num_epochs=200,
                 use_scheduler=use_scheduler)
    with pytest.MonkeyPatch.context() as mp:
        narrow("fakenews", mp)
        spec, opt = fakenews.get_model_spec(args, n_train=8)
        state = create_train_state(spec, args, seed=0, steps_per_epoch=4,
                                   device="cpu", **opt)
    want = make_lr_schedule(1e-4, use_scheduler, 4, spec.sched_step_size,
                            spec.sched_gamma, 200)
    for step in (0, 279, 280, 1000):
        assert state.lr_schedule(step) == pytest.approx(float(want(step)),
                                                        rel=1e-6), step
    assert state.lr_schedule(0) == 1e-4


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("fakenews")
    disk_fixture.build_fakenews_tree(str(root), 20, 8, 8, distinct=4)
    return root


def _data_args(path, model_type, **extra):
    return SimpleNamespace(data_path=str(path) + "/", num_classes=6, seed=0,
                           model_type=model_type, max_seq_len=24,
                           vocab_size=30522, **extra)


@pytest.mark.parametrize("tokenizer", ["wordpiece", "sentencepiece",
                                       "hash"])
def test_disk_dataset_equals_jax(tree, tmp_path, tokenizer):
    """The TSVs without the rows whose image is missing, the tokenizer
    the JAX package picks (WordPiece over the fixture's vocab.txt,
    SentencePiece over a tokenizer.model, or crc32 buckets), images
    resized by PIL's default resample to 224 and scaled to [0, 1]."""
    from test_spm import PIECES, serialize_model

    root = tmp_path / "tree"
    root.mkdir()
    for path in tree.iterdir():
        (root / path.name).symlink_to(path)
    if tokenizer != "wordpiece":
        (root / "vocab.txt").unlink()
    if tokenizer == "sentencepiece":
        (root / "tokenizer.model").write_bytes(serialize_model(PIECES))
    args = _data_args(root, "jlogits")
    got, want = fakenews.get_data(args), jax_fakenews.get_data(args)
    if tokenizer == "hash" and want.train._tokenizer is not None:
        pytest.skip("a local bert-base-uncased tokenizer was found")
    gather_equal(got, want)
    assert got.train.tokenizer == tokenizer
    assert not got.synthetic and got.train_sampler == "sequential"
    assert (len(got.train), len(got.val), len(got.test)) == (17, 7, 7)
    x = got.train.gather(np.arange(2))
    assert x["x2"].shape == (2, 224, 224, 3) and x["x1"].shape == (2, 24)


@pytest.mark.parametrize("model_type", EMBED)
def test_embed_dataset_equals_jax(tree, model_type):
    args = _data_args(tree, model_type)
    got, want = fakenews.get_data(args), jax_fakenews.get_data(args)
    gather_equal(got, want)
    assert not got.synthetic
    x = got.train.gather(np.arange(3))
    assert x["x1"].shape == (3, 768) and ("x3" in x) == (
        model_type.endswith("dialogue"))


def test_dialogue_token_variant_takes_the_twin(tree):
    args = _data_args(tree, "jlogits_dialogue")
    got, want = fakenews.get_data(args), jax_fakenews.get_data(args)
    assert got.synthetic and want.synthetic
    gather_equal(got, want)


def test_embed_dataset_without_dialogue_column_raises(tree, tmp_path):
    path = tmp_path / "frame.pkl"
    path.write_bytes(pickle.dumps({"id": ["a"], "embedding": np.zeros(
        (1, 768)), "label": [0]}))
    with pytest.raises(ValueError, match="dialogue_embedding"):
        fakenews.FakeNewsEmbedDataset(str(tree), str(path), True)


@pytest.mark.parametrize("fmt", ["pth", "safetensors"])
def test_load_pretrained_equals_jax(tmp_path, fmt):
    """A torchvision-layout Bottleneck state_dict (with an fc and
    num_batches_tracked) loads into the embed net's image tower on both
    sides; the token variants refuse it."""
    stages = (1, 1, 1, 1)
    torch.manual_seed(2)
    donor = BottleneckResNetEncoder(3, stages)
    for key, value in donor.state_dict().items():
        if "running_var" in key:
            value.uniform_(0.5, 2.0)
        else:
            value.normal_()
    sd = dict(donor.state_dict())
    sd.update({"fc.weight": torch.randn(1000, 2048),
               "fc.bias": torch.randn(1000),
               "bn1.num_batches_tracked": torch.tensor(3)})
    path = str(tmp_path / f"resnet152.{fmt}")
    if fmt == "pth":
        torch.save(sd, path)
    else:
        from safetensors.torch import save_file

        save_file({k: v.contiguous() for k, v in sd.items()}, path)
    args = _args("fakenews_embed", "jlogits_embed", resnet152_weights=path)
    spec, opt = fakenews.get_model_spec(args, n_train=8)
    state = create_train_state(spec, args, seed=0, steps_per_epoch=4,
                               device="cpu", **opt)
    fc = state.model.fc2.weight.clone()
    state = fakenews.load_pretrained(args, state)
    jspec, _ = jax_fakenews.get_model_spec(args, n_train=8)
    jvars = jax.jit(lambda r: jspec.module.init(
        r, jnp.zeros((1, 768)), jnp.zeros((1, 32, 32, 3)), train=False))(
            jax.random.PRNGKey(0))
    jstate = jax_fakenews.load_pretrained(args, SimpleNamespace(
        params=jvars["params"], batch_stats=jvars["batch_stats"],
        replace=lambda **kw: SimpleNamespace(**kw)))
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    want = load_jax_variables(fakenews.get_model_spec(args, 8)[0].module,
                              to_np(jstate.params),
                              to_np(jstate.batch_stats)).state_dict()
    got = state.model.state_dict()
    for key, value in donor.state_dict().items():
        assert torch.equal(got[f"image_module.{key}"], value), key
        assert torch.equal(want[f"image_module.{key}"], value), key
    assert torch.equal(state.model.fc2.weight, fc)
    token_args = _args("fakenews", "jlogits", resnet152_weights=path)
    with pytest.MonkeyPatch.context() as mp:
        narrow("fakenews", mp)
        spec, opt = fakenews.get_model_spec(token_args, n_train=8)
        token = create_train_state(spec, token_args, seed=0,
                                   steps_per_epoch=4, device="cpu", **opt)
    with pytest.raises(ValueError, match="jlogits_embed"):
        fakenews.load_pretrained(token_args, token)
