"""The port's config, registry and VGGSound data against the JAX
package's on the CPU.

The port reads ``configs/*.yaml`` and ``--set`` values with its own reader
of a YAML subset (``config/merge.py::safe_load``), held here to PyYAML's
``safe_load`` on every config file and on the ``--set`` forms the JAX
package's tests and tools use, and made to raise on what it does not
cover instead of passing the raw text through.
"""

import glob
import os
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

from multimodal_clinical_tpu import benchmarks as jax_benchmarks
from multimodal_clinical_tpu.benchmarks import vggsound as jax_vggsound
from multimodal_clinical_tpu.config import setup_configs as jax_setup_configs
from multimodal_clinical_tpu.engine import run as jax_run

import multimodal_clinical_tpu_torch.__main__ as port_main
from multimodal_clinical_tpu_torch import benchmarks, config
from multimodal_clinical_tpu_torch.benchmarks import (
    available, food101, get_benchmark, vggsound,
)
from multimodal_clinical_tpu_torch.config.merge import safe_load
from multimodal_clinical_tpu_torch.data.synthetic import make_synthetic_splits
from multimodal_clinical_tpu_torch.engine import run

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(os.path.basename(p)
                 for p in glob.glob(str(REPO / "configs" / "*.yaml")))

# the --set values of the repository's tests and tools, and the forms a
# user would type
SET_FORMS = ["8", "16", "ensemble", "qmf", "float32", "true", "True", "false",
             "False", "yes", "off", "1.0e-2", "5.0e-4", "0.1", "-1", "3.",
             ".5", ".inf", "-.Inf", "null", "~", "", "data/vggsound/",
             "/tmp/x/none", "{data: 8, model: 1}", "{stage: 4}", "[0]",
             "[1, 2, 'a', \"b\"]", "[a, [b, c], {d: e}]", "[]", "{}",
             "'quoted # not a comment'", "x  # a comment", "a: b",
             "tcp://localhost:1234", "1e-3", "1.0e3", "\"\\u00e9\\t\"",
             "'it''s'", "OGM_GE"]

UNSUPPORTED = ["- a\n- b", "a:\n  b: 1", "a: 1\n  b: 2", "&x 1", "*x",
               "!!str 1", "0x1F", "017", "0o17", "0b101", "1_000", "1:30",
               "2001-12-14", "|\n  x", ">\n  x", "a: [1, 2", "'x", "\"x",
               "---\na: 1", "a: b: c", "<<", "-.5", "[a] b", "{a: 1} x",
               "a: \"x\\q\""]


@pytest.mark.parametrize("name", CONFIGS)
def test_reader_equals_pyyaml_on_each_config(name):
    text = (REPO / "configs" / name).read_text()
    got, want = safe_load(text), yaml.safe_load(text)
    assert got == want
    assert [type(got[k]) for k in want] == [type(v) for v in want.values()]


@pytest.mark.parametrize("text", SET_FORMS)
def test_reader_equals_pyyaml_on_set_values(text):
    got, want = safe_load(text), yaml.safe_load(text)
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("text", UNSUPPORTED)
def test_reader_raises_on_unsupported_yaml(text):
    with pytest.raises(ValueError, match="unsupported YAML"):
        safe_load(text)


def test_set_value_the_reader_cannot_read_raises():
    with pytest.raises(ValueError, match="--set num_epochs"):
        config.setup_configs(["--dir", "vggsound", "--set",
                              "num_epochs=0x10"])
    with pytest.raises(ValueError, match="KEY=VALUE"):
        config.setup_configs(["--dir", "vggsound", "--set", "num_epochs"])


@pytest.mark.parametrize("argv", [
    ["--dir", "vggsound"],
    ["--dir", "vggsound", "--seed", "3", "--set", "num_epochs=2",
     "--set", "learning_rate=1.0e-3", "--set", "data_path=/tmp/x/none",
     "--set", "mesh_shape={data: 8, model: 1}", "--resume"],
    ["--dir", "avmnist", "--set", "batch_size=8",
     "--set", "model_type=ensemble"],
    ["--dir", "mustard", "--set", "compute_dtype=float32"],
])
def test_setup_configs_equals_jax(argv):
    assert vars(config.setup_configs(argv)) == vars(jax_setup_configs(argv))


def test_legacy_config_flag_equals_jax(tmp_path):
    cfg = tmp_path / "ave.yaml"
    cfg.write_text("batch_size: 4  # legacy runner\nnum_epochs: 3\n")
    argv = ["--config", str(cfg), "--set", "batch_size=2"]
    got = config.setup_configs(argv)
    assert vars(got) == vars(jax_setup_configs(argv))
    assert got.dir == "ave" and got.batch_size == 2 and got.num_epochs == 3


def test_setup_configs_requires_dir():
    with pytest.raises(NotImplementedError, match="--dir"):
        config.setup_configs([])


def test_seed_everything_seeds_torch():
    config.seed_everything(5)
    a = torch.rand(3)
    config.seed_everything(5)
    assert torch.equal(a, torch.rand(3))


def test_registry_serves_vggsound():
    assert get_benchmark("vggsound") is vggsound


@pytest.mark.parametrize("name", ["cremad", "ave", "avmnist", "mimic",
                                  "mustard"])
def test_registry_serves_cremad_and_ave(name):
    module = get_benchmark(name)
    assert module.__name__.endswith(f"benchmarks.{name}")
    assert callable(module.get_data) and callable(module.get_model_spec)


@pytest.mark.parametrize("name,item", [
    ("enrico", 14), ("food101", 15), ("fakenews", 16)])
def test_registry_raises_for_the_other_benchmarks(name, item):
    """The benchmarks of queue A items 14-16, which raised until they were
    ported: Enrico, FakeNews and Food101 are all served, and nothing is
    left unported."""
    module = get_benchmark(name)
    assert module.__name__.endswith(f"benchmarks.{name}")
    assert callable(module.load_pretrained)
    assert name in available()
    assert not benchmarks._NOT_PORTED
    assert sorted(available()) == sorted(jax_benchmarks._REGISTRY)


def test_registry_raises_for_an_unknown_name():
    with pytest.raises(NotImplementedError, match="unknown benchmark"):
        get_benchmark("nosuch")


def test_multiseed_cli_writes_seeds_csv(tmp_path):
    """``--set num_seeds=2`` trains seeds 3 and 4 as one sweep through
    train, val and test, and writes their test metrics to seeds.csv."""
    summary = port_main.run_training(
        ["--dir", "mimic", "--seed", "3", "--set", "num_seeds=2",
         "--set", "num_epochs=1", "--set", f"data_path={tmp_path}/none"],
        device="cpu")
    assert {"test_epoch/test_avg_acc", "test_epoch/test_avg_acc_std",
            "test_epoch/test_avg_acc_seed0",
            "test_epoch/test_avg_acc_seed1"} <= set(summary)
    (path,) = Path(f"{tmp_path}/none_ckpts").glob("*/seeds.csv")
    rows = path.read_text().splitlines()
    assert rows[0].split(",")[:2] == ["seed", "test_epoch/test_avg_acc"]
    assert [r.split(",")[0] for r in rows[1:]] == ["3", "4", "mean", "std"]


@pytest.mark.parametrize("key,value", [("fsdp", True),
                                       ("pipeline_stages", 2),
                                       ("mesh_shape", {"data": 8})])
def test_parallel_settings_raise(key, value, tmp_path, monkeypatch):
    """In one process: ``pipeline_stages`` on VGGSound, whose
    ``get_model_spec`` takes no mesh, raises the JAX package's error
    (``engine/run.py``), a data axis of 8 over one device raises the JAX
    ``make_mesh`` error, and ``fsdp`` raises nothing: at world size 1 the
    JAX rule shards no leaf, so the state stays whole."""
    args = SimpleNamespace(**{key: value})
    if key == "fsdp":
        mesh = run.make_mesh(getattr(args, "mesh_shape", None))
        state = SimpleNamespace(model=torch.nn.Linear(512, 512),
                                optimizer=None)
        assert run.place_state(state, mesh, fsdp=value).sharded is None
        return
    if key == "mesh_shape":
        with pytest.raises(ValueError, match="mesh 8x1x1 != 1 devices"):
            run.run_benchmark(args, vggsound, device="cpu")
        return
    from multimodal_clinical_tpu.data import synthetic as jax_syn
    from multimodal_clinical_tpu_torch.data import synthetic as port_syn

    # the error comes after the data: a narrow twin
    for syn in (jax_syn, port_syn):
        monkeypatch.setitem(syn.BENCHMARK_SHAPES, "vggsound",
                            [(9, 12, 1), (2, 6, 6, 3)])
    argv = ["--dir", "vggsound", "--set", f"{key}={value}",
            "--set", f"data_path={tmp_path}/none"]
    with pytest.raises(NotImplementedError) as want:
        jax_run.run_benchmark(jax_setup_configs(argv), jax_vggsound)
    assert "does not accept a mesh" in str(want.value)
    with pytest.raises(NotImplementedError) as got:
        port_main.run_training(argv, device="cpu")
    assert str(got.value) == str(want.value)
    assert not run._accepts_mesh(vggsound)
    assert run._accepts_mesh(food101)


def test_vggsound_get_data_equals_jax(monkeypatch, tmp_path):
    """The synthetic twin (64/32/32 rows, here at narrow shapes) with
    weighted train and val samplers, as the JAX adapter serves it."""
    shapes = [(9, 12, 1), (2, 6, 6, 3)]
    from multimodal_clinical_tpu.data import synthetic as jax_syn
    from multimodal_clinical_tpu_torch.data import synthetic as port_syn

    monkeypatch.setitem(jax_syn.BENCHMARK_SHAPES, "vggsound", shapes)
    monkeypatch.setitem(port_syn.BENCHMARK_SHAPES, "vggsound", shapes)
    args = SimpleNamespace(num_classes=309, seed=4,
                           data_path=str(tmp_path / "none"))
    got, want = vggsound.get_data(args), jax_vggsound.get_data(args)
    for field in ("train_sampler", "val_sampler", "test_sampler",
                  "synthetic"):
        assert getattr(got, field) == getattr(want, field), field
    assert (got.train_sampler, got.val_sampler) == ("weighted", "weighted")
    for split in ("train", "val", "test"):
        a, b = getattr(got, split), getattr(want, split)
        assert len(a) == len(b) == {"train": 64, "val": 32, "test": 32}[split]
        ga, gb = a.gather(np.arange(len(b))), b.gather(np.arange(len(b)))
        for k in gb:
            np.testing.assert_array_equal(ga[k], gb[k], err_msg=(split, k))


def test_vggsound_disk_dataset_raises(tmp_path):
    """An empty ``vggsound.csv`` admits no clip: the JAX package's error in
    both packages."""
    (tmp_path / "vggsound.csv").write_text("")
    args = SimpleNamespace(num_classes=309, data_path=str(tmp_path) + "/")
    for module in (vggsound, jax_vggsound):
        with pytest.raises(FileNotFoundError,
                           match="0 train clips were admitted"):
            module.get_data(args)


def test_vggsound_spec_fields_equal_jax():
    args = SimpleNamespace(num_classes=3, compute_dtype="float32")
    spec, _ = vggsound.get_model_spec(args, n_train=10)
    jspec, _ = jax_vggsound.get_model_spec(args, n_train=10)
    assert spec.test_restore_best is jspec.test_restore_best is False
    assert spec.legacy_metric_aliases is jspec.legacy_metric_aliases is True
    assert (spec.sched_step_size, spec.sched_gamma) == (
        jspec.sched_step_size, jspec.sched_gamma)


def test_build_loaders_seed_offsets_and_transfer_dtype(tmp_path):
    split = make_synthetic_splits(
        "vggsound", 3, n_train=8, n_val=4, n_test=4,
        shapes=[(3, 4, 1), (1, 2, 2, 3)])
    data = run.DataBundle(*split, train_sampler="weighted",
                          val_sampler="random")
    args = SimpleNamespace(batch_size=4, seed=7, compute_dtype="bfloat16",
                           loader_workers=2)
    train, val, test = run.build_loaders(args, data, device="cpu")
    assert (train.sampler.seed, val.sampler.seed) == (7, 8)
    assert type(test.sampler).__name__ == "SequentialSampler"
    assert train.transfer_dtype is torch.bfloat16 and train.workers == 2
    args.transfer_dtype = "float32"
    assert run.build_loaders(args, data, "cpu")[0].transfer_dtype is None


def test_use_wandb_warns_and_trains(tmp_path, monkeypatch, capsys):
    """``use_wandb`` set and wandb not importable: the run says so on
    stderr, as the JAX logger does (``utils/logging.py:28-38``), and
    trains, logging every row to ``metrics.jsonl``."""
    import json
    import sys

    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb fails
    summary = port_main.run_training(
        ["--dir", "mimic", "--set", "num_epochs=1", "--set", "use_wandb=True",
         "--set", f"data_path={tmp_path}/none", "--set",
         f"ckpt_dir={tmp_path}/runs"], device="cpu")
    assert "[logger] wandb disabled (" in capsys.readouterr().err
    (path,) = Path(f"{tmp_path}/runs").glob("*/metrics.jsonl")
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["epoch"] for r in rows if "epoch" in r] == [0, -1]
    assert rows[-1]["test_epoch/test_avg_loss"] == pytest.approx(
        summary["test_epoch/test_avg_loss"])
