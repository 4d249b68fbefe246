"""Enrico in the port (``benchmarks/enrico.py``, the frozen towers'
weight-decay mask) against the JAX package on the CPU.

The step checks are ``tests/torch_port_contract_harness.py``'s: losses
within 1e-5 relative, updates and momentum within 3e-4 of each tensor's
largest entry, a frozen leaf bit-unchanged with no momentum on both
sides.  Every model type trains two steps and evaluates once on both
sides through ``tests/torch_port_benchmark_harness.py`` (ResNets at
width 16 with one block a stage, the VGG stack at an eighth of its
widths, 64 x 32 screens; the VGG variant's eight dropouts a tower
injected).  The disk gathers and ``_apply_noise`` are bit-equal.  The
CLI writes the JAX CLI's ``metrics.jsonl`` keys, ``--resume`` restores
the saved state, and a preempted frozen-VGG run resumes bit-equal.  The
towers and ``adaptive_avg_pool2d``: ``test_torch_port_enrico_towers.py``.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.benchmarks import enrico as jax_enrico
from multimodal_clinical_tpu.data.core import ArrayDataset as JaxArrayDataset
from multimodal_clinical_tpu.utils import native as jax_native
from multimodal_clinical_tpu_torch.benchmarks import disk_fixture, enrico
from multimodal_clinical_tpu_torch.data.core import ArrayDataset
from multimodal_clinical_tpu_torch.engine.state import create_train_state
from multimodal_clinical_tpu_torch.engine.steps import make_train_step
from multimodal_clinical_tpu_torch.models import pretrained
from multimodal_clinical_tpu_torch.models.jax_weights import (
    jax_key_map, load_jax_variables,
)
from multimodal_clinical_tpu_torch.utils import native
from torch_port_benchmark_harness import (
    _args, check_cli_keys, cli_pair, gather_equal, narrow,
    preempted_run_resumes_bit_equal, resume_one_more_epoch, run_pair,
    spec_equal_jax,
)
from torch_port_contract_harness import (
    _to_port, check_eval, check_qmf_tables, check_state, check_train_metrics,
)

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False


def test_model_types_are_jax_s():
    assert enrico.MODEL_TYPES == jax_enrico.MODEL_TYPES


@pytest.mark.parametrize("model_type", enrico.MODEL_TYPES)
def test_spec_equals_jax(model_type):
    spec_equal_jax("enrico", model_type)


@pytest.mark.parametrize("model_type", ["jlogits", "jlogits_counts"])
def test_frozen_prefixes_name_the_jax_frozen_leaves(model_type):
    """A port parameter is frozen exactly where its flax leaf is under the
    JAX spec's '/'-joined prefixes: the ResNet towers' ``features``, the
    VGG towers' conv and BN layers, not the classifiers."""
    args = _args("enrico", model_type)
    spec, _ = enrico.get_model_spec(args, n_train=8)
    jspec, _ = jax_enrico.get_model_spec(args, n_train=8)
    frozen = []
    for key, (coll, path, _) in jax_key_map(spec.module).items():
        if coll != "params":
            continue
        port = key.startswith(tuple(spec.frozen_prefixes))
        jax_side = "/".join(path).startswith(tuple(jspec.frozen_prefixes))
        assert port == jax_side, key
        frozen.append(port)
    assert any(frozen) and not all(frozen)


def test_unknown_model_type_raises():
    with pytest.raises(NotImplementedError, match="enrico model_type"):
        enrico.get_model_spec(_args("enrico", "jprobas"), n_train=4)


@pytest.mark.parametrize("model_type", enrico.MODEL_TYPES)
def test_two_steps_and_eval_match_jax(model_type):
    run = run_pair("enrico", model_type)
    check_train_metrics(run)
    check_state(run)
    check_qmf_tables(run)
    check_eval(run)
    assert run["noise_calls"] == 0
    dropped = run["dropped"]
    if model_type == "jlogits_counts":
        assert run["n_dropouts"] == 16
        assert len(dropped["jax"]) == 16
        assert dropped["port"] == dropped["jax"] * 2
        assert all(keep == pytest.approx(0.8) for _, keep in dropped["jax"])
    else:
        assert dropped == {"jax": [], "port": []}
    if model_type.startswith("jlogits"):
        # the frozen towers' running statistics still move
        sd = run["state"].model.state_dict()
        key = "x1_model.features.1.running_mean" if (
            model_type == "jlogits_counts") else (
                "x1_model.features.bn1.running_mean")
        assert not torch.equal(sd[key], run["init"][key])


def test_frozen_leaves_stay_bit_equal_over_sgd_steps():
    """Four SGD steps (momentum 0.9, weight decay 1e-4) of the port alone:
    every frozen leaf bit-unchanged with no momentum buffer and no
    gradient, the classifiers moved with one."""
    with pytest.MonkeyPatch.context() as mp:
        narrow("enrico", mp)
        args = _args("enrico", "jlogits")
        spec, opt = enrico.get_model_spec(args, n_train=8)
        state = create_train_state(spec, args, seed=0, steps_per_epoch=10,
                                   device="cpu", **opt)
    init = {k: v.clone() for k, v in state.model.named_parameters()}
    groups = state.optimizer.param_groups
    assert [g["weight_decay"] for g in groups] == [1e-4, 0.0]
    step = make_train_step(spec)
    rng = np.random.default_rng(5)
    for _ in range(4):
        batch = {f"x{i}": rng.integers(0, 256, (4, 32, 16, 3),
                                       dtype=np.uint8) for i in (1, 2)}
        batch.update(label=rng.integers(0, 20, 4),
                     valid=np.ones(4, np.float32))
        state, _ = step(state, _to_port(batch))
    for name, param in state.model.named_parameters():
        frozen = name.startswith(spec.frozen_prefixes)
        kept = state.optimizer.state[param]
        if frozen:
            assert param.grad is None and not kept, name
            assert torch.equal(param, init[name]), name
        else:
            assert "momentum_buffer" in kept, name
            assert not torch.equal(param, init[name]), name


def _native(on, mp):
    if on:
        if not jax_native.available():
            pytest.skip("native/libfastdata.so does not load here")
        mp.setattr(native, "_lib", None)
        mp.setattr(native, "_tried", False)
        assert native.available()
    else:
        for module in (native, jax_native):
            mp.setattr(module, "_lib", None)
            mp.setattr(module, "_tried", True)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("enrico")) + "/"
    disk_fixture.build_enrico_tree(root, 40, size=(60, 100), distinct=6)
    return root


@pytest.mark.parametrize("host", ["native", "pil"])
def test_get_data_equals_jax_on_files(tree, host, monkeypatch):
    """The CSV without the two ignored ids, the seed-42 65/15/20 split,
    the screenshots through the native decode (or PIL) and the PNG
    wireframes through PIL bilinear, as uint8 256 x 128."""
    _native(host == "native", monkeypatch)
    args = SimpleNamespace(data_path=tree, num_classes=20, seed=3)
    got, want = enrico.get_data(args), jax_enrico.get_data(args)
    gather_equal(got, want)
    assert not got.synthetic and got.train_sampler == "weighted"
    assert (len(got.train), len(got.val), len(got.test)) == (26, 6, 8)
    x = got.train.gather(np.arange(3))
    assert x["x1"].dtype == np.uint8 and x["x1"].shape == (3, 256, 128, 3)


def test_get_data_equals_jax_on_the_twin(tmp_path):
    args = _args("enrico", "jlogits", data_path=str(tmp_path), seed=2)
    gather_equal(enrico.get_data(args), jax_enrico.get_data(args))


@pytest.mark.parametrize("noise_p,label_noise_p", [(0.5, 0.0), (0.0, 0.3),
                                                   (0.4, 0.4)])
def test_apply_noise_equals_jax(noise_p, label_noise_p):
    rng = np.random.default_rng(9)
    x1 = rng.integers(0, 256, (30, 4, 2, 3), dtype=np.uint8)
    x2 = rng.integers(0, 256, (30, 4, 2, 3), dtype=np.uint8)
    labels = (np.arange(30) % 5).astype(np.int32)
    got = enrico._apply_noise(ArrayDataset([x1, x2], labels), noise_p,
                              label_noise_p, 5, seed=4)
    want = jax_enrico._apply_noise(JaxArrayDataset([x1, x2], labels),
                                   noise_p, label_noise_p, 5, seed=4)
    for a, b in zip(got.modalities + [got.labels],
                    want.modalities + [want.labels]):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(got.modalities[0], x1) or noise_p == 0
    assert not np.array_equal(got.labels, labels) or label_noise_p == 0


def test_load_pretrained_equals_jax(tmp_path):
    """A torchvision-layout resnet18 state_dict (with its fc and
    num_batches_tracked) loads into both towers' features on both sides."""
    torch.manual_seed(1)
    donor = pretrained.ResNet18Slim(1000)
    for key, value in donor.features.state_dict().items():
        if "running_var" in key:
            value.uniform_(0.5, 2.0)
        elif value.is_floating_point():
            value.normal_()
    sd = dict(donor.features.state_dict())
    sd.update({"fc.weight": torch.randn(1000, 512),
               "fc.bias": torch.randn(1000),
               "bn1.num_batches_tracked": torch.tensor(7)})
    path = str(tmp_path / "resnet18.pth")
    torch.save(sd, path)
    args = _args("enrico", "jlogits", torchvision_weights=path)
    spec, opt = enrico.get_model_spec(args, n_train=8)
    state = create_train_state(spec, args, seed=0, steps_per_epoch=10,
                               device="cpu", **opt)
    classifier = state.model.x1_model.classifier.weight.clone()
    state = enrico.load_pretrained(args, state)
    jspec, _ = jax_enrico.get_model_spec(args, n_train=8)
    x = jnp.zeros((1, 32, 16, 3))
    jvars = jax.jit(lambda r: jspec.module.init(r, x, x, train=False))(
        jax.random.PRNGKey(0))
    jstate = jax_enrico.load_pretrained(args, SimpleNamespace(
        params=jvars["params"], batch_stats=jvars["batch_stats"],
        replace=lambda **kw: SimpleNamespace(**kw)))
    want = load_jax_variables(
        enrico.get_model_spec(args, n_train=8)[0].module,
        jax.tree_util.tree_map(np.asarray, jstate.params),
        jax.tree_util.tree_map(np.asarray, jstate.batch_stats)).state_dict()
    got = state.model.state_dict()
    for tower in ("x1_model", "x2_model"):
        for key, value in donor.features.state_dict().items():
            name = f"{tower}.features.{key}"
            assert torch.equal(got[name], value), name
            assert torch.equal(want[name], value), name
    assert torch.equal(state.model.x1_model.classifier.weight, classifier)


def test_load_pretrained_is_a_no_op_when_unset():
    state = SimpleNamespace(model=None)
    assert enrico.load_pretrained(_args("enrico", "jlogits"), state) is state


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("enrico_cli")
    return root, cli_pair("enrico", "jlogits", root)


def test_cli_metrics_keys_equal_jax(cli_runs):
    _, runs = cli_runs
    check_cli_keys(runs)
    assert "test_epoch/test_avg_x2_acc_uncal" in runs["port"][0]


def test_cli_resumes_one_more_epoch(cli_runs):
    root, _ = cli_runs
    saved, seen = resume_one_more_epoch("enrico", "jlogits", root / "port")
    # the frozen towers' leaves have no optimizer state in the checkpoint
    model = saved["model"]
    n_frozen = sum(1 for k in model if k.startswith(
        ("x1_model.features", "x2_model.features")) and (
            k.endswith("weight") or k.endswith("bias")))
    n_params = sum(1 for k in model if not any(
        s in k for s in ("running_", "num_batches")))
    assert len(saved["optimizer"]["state"]) == n_params - n_frozen


def test_preempted_vgg_run_resumes_bit_equal(tmp_path):
    """jlogits_counts (frozen VGG11Slim stacks, 16 dropouts drawn from the
    step's generator) preempted mid-epoch and resumed: bit-equal to an
    uninterrupted run, the frozen leaves still without optimizer state."""
    state = preempted_run_resumes_bit_equal("enrico", "jlogits_counts",
                                            tmp_path, after=1)
    frozen = [p for n, p in state.model.named_parameters()
              if n.startswith(("x1_model.features", "x2_model.features"))]
    assert frozen and not any(state.optimizer.state[p] for p in frozen)
    assert state.step == 4
