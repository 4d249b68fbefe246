"""Food101's SigLIP family in the port (``benchmarks/food101.py``,
``Food101FusionNet``) against the JAX package on the CPU.

Every model type (jlogits, ensemble, ogm_ge, qmf) trains two steps under
SGD and evaluates once through ``tests/torch_port_benchmark_harness.py``,
whose checks are ``tests/torch_port_contract_harness.py``'s: the SigLIP
towers at ``SIGLIP_TINY`` on both sides, 16-token rows (each padded at its
tail, the second row all padding) and 32 x 32 pixels, the heads' four
dropouts injected.  Numpy data seed 0 crosses no ReLU or softmax threshold
within fp32 rounding: the two sides' losses agree to 1e-7 relative, well
inside the harness's 1e-5.  The key projections' biases have a gradient
that is zero in exact arithmetic: held to rounding.  ogm_ge modulates
nothing (the heads hold no 4-D leaf; the patch conv sits under ``model``)
and draws no noise, so its gradients equal jlogits' bit for bit.  The
twin's and the disk files' gathers and ``load_pretrained`` are bit-equal.
The towers: ``test_torch_port_siglip.py``; the CLI:
``test_torch_port_food101_cli.py``.
"""

import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.benchmarks import food101 as jax_food101
from multimodal_clinical_tpu.models import siglip as jsig
import multimodal_clinical_tpu_torch.__main__ as port_main
from multimodal_clinical_tpu_torch.algos.ogm_ge import modulated_parameters
from multimodal_clinical_tpu_torch.benchmarks import disk_fixture, food101
from multimodal_clinical_tpu_torch.engine import steps as port_steps
from multimodal_clinical_tpu_torch.engine.state import create_train_state
from multimodal_clinical_tpu_torch.models.jax_weights import (
    load_jax_variables,
)
from torch_port_benchmark_harness import (
    SIGLIP_TINY, _args, cli_argv, gather_equal, narrow, run_pair,
    spec_equal_jax,
)
from torch_port_contract_harness import (
    check_eval, check_qmf_tables, check_state, check_train_metrics,
)

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False

TYPES = ("jlogits", "ensemble", "ogm_ge", "qmf")
ROUNDING = (".k_proj.bias",)


@pytest.fixture(scope="module")
def runs():
    """Each model type's run, once per module; the port's OGM noise
    source records every draw."""
    noise = []

    def device_noise(seed, step):
        def draw(name, grad):
            noise.append(name)
            return torch.zeros_like(grad)
        return draw

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_steps, "device_noise", device_noise)
        out = {t: run_pair("food101", t) for t in TYPES}
    return out, noise


def test_model_types_are_jax_s():
    assert food101.MODEL_TYPES == jax_food101.MODEL_TYPES


@pytest.mark.parametrize("model_type", TYPES)
def test_spec_equals_jax(model_type):
    with pytest.MonkeyPatch.context() as mp:
        narrow("food101", mp)
        spec_equal_jax("food101", model_type)


@pytest.mark.parametrize("model_type", TYPES)
def test_two_steps_and_eval_match_jax(runs, model_type):
    run = runs[0][model_type]
    check_train_metrics(run)
    check_state(run, rounding_grads=ROUNDING)
    check_qmf_tables(run)
    check_eval(run)
    spec, state = run["spec"], run["state"]
    assert (spec.sched_step_size, spec.sched_gamma) == (50, 0.5)
    assert state.lr_metric_name == run["jstate"].lr_metric_name
    # the heads' four dropouts: drawn once in the JAX trace, at each of
    # the port's two steps
    assert run["n_dropouts"] == 4
    assert run["dropped"]["jax"] == [((6, 512), 0.8)] * 4
    assert run["dropped"]["port"] == run["dropped"]["jax"] * 2
    for m, jm in zip(run["metrics"], run["jmetrics"]):
        np.testing.assert_allclose(m["train_loss"], jm["train_loss"],
                                   rtol=1e-6)


def test_ogm_ge_modulates_nothing_and_draws_no_noise(runs):
    """The heads hold no 4-D leaf, so neither side modulates or draws:
    ogm_ge's gradients are jlogits' bit for bit."""
    out, noise = runs
    ogm, plain = out["ogm_ge"], out["jlogits"]
    assert ogm["spec"].apply_grad_mod and ogm["spec"].grad_mod_type == (
        "OGM_GE")
    assert ogm["noise_calls"] == 0 and not noise
    assert not list(modulated_parameters(ogm["state"].model))
    assert any(p.ndim == 4 for p in ogm["state"].model.parameters())
    for step_ogm, step_plain in zip(ogm["grads"], plain["grads"]):
        assert step_ogm.keys() == step_plain.keys()
        for key, g in step_ogm.items():
            assert np.array_equal(g, step_plain[key]), key


def test_qmf_history_written_at_the_real_idx_only(runs):
    run = runs[0]["qmf"]
    seen = np.concatenate([b["idx"][b["valid"] > 0] for b in run["batches"]])
    tables = run["state"].qmf_correctness.numpy()
    assert (tables[:, seen] != 0).all()
    assert not np.delete(tables, seen, axis=1).any()
    assert run["spec"].n_train_samples == tables.shape[1]


def test_unknown_model_type_raises():
    with pytest.raises(NotImplementedError, match="food101 model_type"):
        food101.get_model_spec(_args("food101", "nosuch"), n_train=4)


@pytest.mark.parametrize("model_type", food101.LEGACY_TYPES)
def test_legacy_types_build_spec_data_and_run_the_cli(tmp_path, model_type):
    """jprobas and jprobas_jlogits (the frozen ResNet50 + BERT pair) build
    the JAX package's spec and data, and the CLI trains, validates,
    checkpoints and tests them on the twin (narrowed through the config's
    keys; parity in ``test_torch_port_food101_legacy*.py``)."""
    args = _args("food101_legacy", model_type,
                 data_path=f"{tmp_path}/none")
    spec, _ = food101.get_model_spec(args, n_train=4)
    assert type(spec.module).__name__ == "Food101LegacyFusionNet"
    assert spec.contract == "jprobas" and spec.frozen_prefixes
    data, jdata = food101.get_data(args), jax_food101.get_data(args)
    gather_equal(data, jdata)
    summary = port_main.run_training(
        cli_argv("food101_legacy", tmp_path, model_type, "--set",
                 "num_epochs=1"), device="cpu")
    assert np.isfinite(summary["test_epoch/test_avg_acc"])
    assert sorted(p.name for p in tmp_path.glob("*/ckpt/*")) == [
        "best", "last-1", "meta.json"]


@pytest.mark.parametrize("key", ["resnet50_weights", "bert_weights"])
def test_legacy_weights_under_siglip_types_raise_like_jax(key):
    """``resnet50_weights``/``bert_weights`` apply to the legacy types
    only: under qmf both packages raise the same ``ValueError`` before
    reading the file."""
    args = _args("food101", "qmf", **{key: "/nonexistent"})
    with pytest.MonkeyPatch.context() as mp:
        narrow("food101", mp)
        spec, opt = food101.get_model_spec(args, n_train=4)
        state = create_train_state(spec, args, seed=0, steps_per_epoch=4,
                                   device="cpu", **opt)
    with pytest.raises(ValueError, match="legacy jprobas/jprobas_jlogits "
                       "variants only") as got:
        food101.load_pretrained(args, state)
    jstate = SimpleNamespace(params={"model": {}, "x1_model": {},
                                     "x2_model": {}})
    with pytest.raises(ValueError) as want:
        jax_food101.load_pretrained(args, jstate)
    assert str(got.value) == str(want.value)


def _data_args(path, model_type="qmf"):
    return SimpleNamespace(data_path=str(path) + "/", num_classes=101,
                           seed=5, model_type=model_type)


def test_twin_equals_jax(tmp_path):
    """The 128/32/32 synthetic twin at the published geometry (64 ids,
    224 x 224 x 3 pixels), read in order."""
    args = _data_args(tmp_path / "none")
    got, want = food101.get_data(args), jax_food101.get_data(args)
    gather_equal(got, want)
    assert got.synthetic and got.train_sampler == "sequential"
    assert (len(got.train), len(got.val), len(got.test)) == (128, 32, 32)
    x = got.train.gather(np.arange(2))
    assert x["x1"].shape == (2, 64) and x["x1"].dtype == np.int32
    assert x["x2"].shape == (2, 224, 224, 3)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("food101")
    made = disk_fixture.build_food101_tree(str(root), 7, 4, 3, distinct=3)
    return root, made


def test_disk_dataset_equals_jax(tree):
    """``my_{train,dev,test}_food.txt`` and the per-sample ``.npy`` pairs
    (ids (1, 64); pixels CHW, every third (1, 3, 224, 224)) gathered bit
    for bit as the JAX package gathers them, the pixels turned HWC."""
    root, made = tree
    args = _data_args(root)
    got, want = food101.get_data(args), jax_food101.get_data(args)
    gather_equal(got, want)
    assert made["rows"] == 14 and not got.synthetic
    assert (len(got.train), len(got.val), len(got.test)) == (7, 4, 3)
    assert got.train_sampler == "sequential"
    x = got.train.gather(np.arange(7))
    assert x["x1"].shape == (7, 64) and x["x2"].shape == (7, 224, 224, 3)
    assert x["x1"].dtype == np.int32 and x["x2"].dtype == np.float32
    assert list(x["label"]) == list(range(7))
    chw = np.load(root / "tokens" / "food_000002_pixel_values.npy")
    assert chw.shape == (1, 3, 224, 224)
    np.testing.assert_array_equal(x["x2"][2], chw[0].transpose(1, 2, 0))


@pytest.mark.parametrize("fmt", ["pytorch_model.bin", "model.safetensors"])
def test_load_pretrained_equals_jax(tmp_path, fmt):
    """``siglip_weights``: a seeded HF-layout state_dict loaded into the
    towers on both sides (the JAX port's geometry keywords set to the tiny
    towers'); the heads untouched."""
    torch.manual_seed(3)
    with pytest.MonkeyPatch.context() as mp:
        narrow("food101", mp)
        mp.setattr(jsig, "port_siglip_state_dict", functools.partial(
            jsig.port_siglip_state_dict, width=SIGLIP_TINY["width"],
            heads=SIGLIP_TINY["heads"], layers=SIGLIP_TINY["layers"]))
        args = _args("food101", "qmf", siglip_weights=str(tmp_path))
        spec, opt = food101.get_model_spec(args, n_train=8)
        state = create_train_state(spec, args, seed=0, steps_per_epoch=4,
                                   device="cpu", **opt)
        hf = {k: torch.randn(v.shape) for k, v in
              state.model.model.state_dict().items()}
        hf.update(logit_scale=torch.ones(1), logit_bias=torch.zeros(1))
        if fmt.endswith(".bin"):
            torch.save(hf, tmp_path / fmt)
        else:
            from safetensors.torch import save_file

            save_file(hf, str(tmp_path / fmt))
        head = state.model.x1_model.mlp[0].weight.clone()
        state = food101.load_pretrained(args, state)
        jspec, _ = jax_food101.get_model_spec(args, n_train=8)
        ids = np.zeros((1, 16), np.int32)
        variables = jax.jit(functools.partial(jspec.module.init,
                                              train=False))(
            jax.random.PRNGKey(0), ids, np.zeros((1, 32, 32, 3), np.float32))
        jstate = jax_food101.load_pretrained(args, SimpleNamespace(
            params=variables["params"],
            replace=lambda **kw: SimpleNamespace(**kw)))
        want = load_jax_variables(
            food101.get_model_spec(args, 8)[0].module,
            jax.tree_util.tree_map(np.asarray, jstate.params), {})
    got = state.model.state_dict()
    for key, value in hf.items():
        if not key.startswith("logit"):
            assert torch.equal(got[f"model.{key}"], value), key
            assert torch.equal(want.state_dict()[f"model.{key}"], value), key
    assert torch.equal(state.model.x1_model.mlp[0].weight, head)
