"""The port's multi-seed sweep (``engine/multiseed.py``) against the JAX
package's on the CPU.

The whole sweep runs on an AV-MNIST twin (seeds 0, 1 and 2, batch 16,
two epochs: the geometry of ``test_engine_extras.py::
test_multiseed_vmapped_sweep``) at AV-MNIST's configured learning rate,
1e-3 (``configs/avmnist.yaml``). At that test's 0.1 the training is
chaotic: the grouped convolutions' rounding alone parts the port's own
sweep from its single-seed runs by 1e-2 of the loss within eight steps,
and the two packages' sweeps part the same way. The JAX sweep draws each
seed's weights with its flax init (compiled once for the three seeds):
they are captured as its ``create_train_state`` returns them and loaded
into the port's per-seed nets (``load_jax_variables``) before the port
stacks them. Each seed's train losses, step by step, agree to 1e-5
relative (the tolerance of ``test_torch_port_step.py``), its test losses
too; accuracies, the summary's keys and ``seeds.csv``'s header and seed
column are equal. LeNet's fp32 steps on these data cross no ReLU or
max-pool threshold within rounding (a crossing shows as losses apart
beyond that limit).

The parts are held one by one: ``MultiSeedLoader``'s superbatches bit
for bit, on per-seed and on shared data; ``BestValTracker`` case by
case, ties included; ``multiseed_eval_summary`` on the same outputs;
each refusal with the JAX sweep's words. vmap's per-sample fallback
warning is an error here, as in ``torch_port_multiseed_harness.py``.
"""

from __future__ import annotations

import csv
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.benchmarks import avmnist as jax_avmnist
from multimodal_clinical_tpu.data.synthetic import (
    make_synthetic_splits as jax_splits,
)
from multimodal_clinical_tpu.engine import metrics as jax_metrics
from multimodal_clinical_tpu.engine import multiseed as jax_multiseed
from multimodal_clinical_tpu.engine.run import (
    DataBundle as JaxBundle, _make_sampler as jax_make_sampler,
)
from multimodal_clinical_tpu.models import zoo as jax_zoo
from multimodal_clinical_tpu_torch.benchmarks import avmnist
from multimodal_clinical_tpu_torch.data.synthetic import make_synthetic_splits
from multimodal_clinical_tpu_torch.engine import metrics
from multimodal_clinical_tpu_torch.engine import multiseed
from multimodal_clinical_tpu_torch.engine.run import (
    DataBundle, _make_sampler,
)
from multimodal_clinical_tpu_torch.models.jax_weights import (
    load_jax_variables,
)
from torch_port_contract_harness import FAST_INIT
from torch_port_multiseed_harness import (  # noqa: F401 (autouse)
    vmap_fallback_is_an_error,
)

torch.set_num_threads(2)

SEEDS = [0, 1, 2]
LOSS_RTOL = 1e-5


def make_args(tmp_path, side: str, **overrides):
    """``test_engine_extras.make_args`` at AV-MNIST's configured learning
    rate."""
    base = dict(
        num_classes=4, batch_size=16, learning_rate=1e-3, num_epochs=2,
        dropout_p=0.1, data_path="/nonexistent", num_cpus=1, use_wandb=False,
        model_type="jlogits", group_name="t", seed=0, use_scheduler=False,
        grad_mod_type=None, alpha=0.1, mesh_shape=None,
        ckpt_dir=str(tmp_path / side), log_every_n_steps=0, noise_p=0.0,
        label_noise_p=0.0)
    base.update(overrides)
    return SimpleNamespace(**base)


def _record_train_losses(mp, accumulator_cls, losses):
    """Every step's (S,) train loss, as the sweep hands it to the epoch
    accumulator."""
    append = accumulator_cls.append

    def recording(self, step_metrics):
        losses.append(np.asarray(step_metrics["train_loss"]).copy())
        return append(self, step_metrics)

    mp.setattr(accumulator_cls, "append", recording)


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _compiled_init(flax_init):
    """The flax init compiled once, without XLA's backend optimisations
    (the harnesses' ``FAST_INIT``: the eager init compiles op by op for
    longer than the sweep trains), and called with each seed's keys."""
    compiled = []

    def init(module, rngs, *inputs, train=False):
        if not compiled:
            compiled.append(jax.jit(
                lambda r, *xs: flax_init(module, r, *xs, train=train)
            ).lower(rngs, *inputs).compile(FAST_INIT))
        return compiled[0](rngs, *inputs)

    return init


def test_avmnist_sweep_equals_jax(tmp_path, monkeypatch):
    captured, jax_losses, port_losses = [], [], []
    monkeypatch.setattr(jax_zoo.AVMnistFusionNet, "init",
                        _compiled_init(jax_zoo.AVMnistFusionNet.init))
    create = jax_multiseed.create_train_state

    def capturing(*args, **kwargs):
        state = create(*args, **kwargs)
        captured.append(jax.tree_util.tree_map(
            np.array, (state.params, state.batch_stats)))
        return state

    monkeypatch.setattr(jax_multiseed, "create_train_state", capturing)
    _record_train_losses(monkeypatch, jax_metrics.EpochAccumulator,
                         jax_losses)
    want = jax_multiseed.run_multiseed(make_args(tmp_path, "jax"),
                                       jax_avmnist, SEEDS)
    assert len(captured) == len(SEEDS)

    loaded = []

    def from_jax(module, generator):
        params, stats = captured[len(loaded)]
        loaded.append(generator.initial_seed())
        return load_jax_variables(module, params, stats)

    monkeypatch.setattr(multiseed, "init_weights", from_jax)
    _record_train_losses(monkeypatch, metrics.EpochAccumulator, port_losses)
    got = multiseed.run_multiseed(make_args(tmp_path, "port"), avmnist,
                                  SEEDS, device="cpu")
    assert loaded == SEEDS

    # 8 steps an epoch (128 rows), 2 epochs, each step's loss per seed
    assert len(port_losses) == len(jax_losses) == 16
    np.testing.assert_allclose(np.stack(port_losses), np.stack(jax_losses),
                               rtol=LOSS_RTOL)
    assert set(got) == set(want)
    for key, value in want.items():
        if "_loss" in key and not key.endswith("_std"):
            np.testing.assert_allclose(got[key], value, rtol=LOSS_RTOL,
                                       err_msg=key)
        elif "_loss" not in key:
            assert got[key] == value, key
    # the sweep's seeds learn apart: independent inits and data
    assert len({round(got[f"test_epoch/test_avg_loss_seed{s}"], 6)
                for s in range(len(SEEDS))}) > 1

    rows = _read_csv(tmp_path / "port" / "t" / "seeds.csv")
    jax_rows = _read_csv(tmp_path / "jax" / "t" / "seeds.csv")
    assert rows[0] == jax_rows[0]
    assert [r[0] for r in rows] == [r[0] for r in jax_rows] == [
        "seed", "0", "1", "2", "mean", "std"]
    # the values are each side's summary: per seed, then mean and std
    for table, summary in ((rows, got), (jax_rows, want)):
        keys = table[0][1:]
        suffixes = [f"_seed{s}" for s in range(len(SEEDS))] + ["", "_std"]
        for row, suffix in zip(table[1:], suffixes):
            assert [float(v) for v in row[1:]] == [
                summary[k + suffix] for k in keys], row[0]


def _bundles(shared: bool):
    """(port bundles, JAX bundles) of an AV-MNIST twin, one a seed, each
    side made by its own package."""
    def make(splits, bundle, seed):
        return bundle(*splits("avmnist", 4, seed=seed, n_train=40, n_val=16,
                              n_test=16), train_sampler="random",
                      synthetic=True)

    seeds = [0] * len(SEEDS) if shared else SEEDS
    return ([make(make_synthetic_splits, DataBundle, s) for s in seeds],
            [make(jax_splits, JaxBundle, s) for s in seeds])


@pytest.mark.parametrize("shared", [False, True], ids=["per_seed", "shared"])
def test_multiseed_loader_superbatches_equal_jax(shared):
    """Superbatches of (S, B, ...) rows, the tail padded, bit-equal to the
    JAX loader's, in fp32, over two epochs of per-seed random orders."""
    bundles, jax_bundles = _bundles(shared)
    datasets = bundles[0].train if shared else [b.train for b in bundles]
    jax_datasets = (jax_bundles[0].train if shared
                    else [b.train for b in jax_bundles])
    port = multiseed.MultiSeedLoader(
        datasets, 16, [_make_sampler("random", b.train, s)
                       for s, b in zip(SEEDS, bundles)], device="cpu")
    want = jax_multiseed.MultiSeedLoader(
        jax_datasets, 16, [jax_make_sampler("random", b.train, s)
                           for s, b in zip(SEEDS, jax_bundles)])
    assert len(port) == len(want) == 3
    for epoch in range(2):
        port.set_epoch(epoch)
        want.set_epoch(epoch)
        got_batches, want_batches = list(port), list(want)
        assert len(got_batches) == len(want_batches) == 3
        for got, ref in zip(got_batches, want_batches):
            assert set(got) == set(ref)
            for key, value in ref.items():
                value = np.asarray(value)
                assert got[key].shape == value.shape, key
                assert got[key].numpy().dtype == value.dtype, key
                np.testing.assert_array_equal(got[key].numpy(), value, key)
        # the tail batch: 40 rows = 2 full batches and 8 real rows
        assert got_batches[-1]["valid"].sum(dim=1).tolist() == [8.0] * 3


def test_best_val_tracker_matches_jax():
    """Epoch by epoch: the first epoch snapshots every seed, then a seed
    snapshots only on a strictly greater accuracy (a tie keeps the earlier
    epoch)."""
    rng = np.random.default_rng(0)
    accs = np.array([[0.5, 0.5, 0.5], [0.6, 0.5, 0.4], [0.6, 0.7, 0.4],
                     [0.55, 0.7, 0.45]], np.float32)
    port = multiseed.BestValTracker(3)
    want = jax_multiseed.BestValTracker(3)
    for epoch, acc in enumerate(accs):
        params = {"w": rng.normal(size=(3, 2, 5)).astype(np.float32),
                  "b": rng.normal(size=(3, 4)).astype(np.float32)}
        stats = {"mean": rng.normal(size=(3, 4)).astype(np.float32)}
        improved = port.update(
            acc, {k: torch.from_numpy(v.copy()) for k, v in params.items()},
            {k: torch.from_numpy(v.copy()) for k, v in stats.items()})
        jax_improved = want.update(
            acc, {k: jnp.asarray(v) for k, v in params.items()},
            {k: jnp.asarray(v) for k, v in stats.items()})
        np.testing.assert_array_equal(improved, jax_improved)
        np.testing.assert_array_equal(port.acc, want.acc)
        for got, ref in ((port.params, want.params),
                         (port.stats, want.stats)):
            assert set(got) == set(ref)
            for key in ref:
                np.testing.assert_array_equal(got[key].numpy(),
                                              np.asarray(ref[key]), key)
    # epochs 1 and 2 improved seeds 0 and 1 (and kept seed 2's epoch-0 ties)
    np.testing.assert_array_equal(port.acc,
                                  np.array([0.6, 0.7, 0.5], np.float32))


@pytest.mark.parametrize("contract", ["jlogits", "ensemble", "qmf"])
def test_eval_summary_matches_jax(contract):
    """Per-seed epoch summaries with mean, ``_std`` and ``_seed{s}`` keys,
    the same numpy arithmetic on the same outputs."""
    rng = np.random.default_rng(1)
    seeds, batch, classes = 3, 8, 4
    outputs = []
    for _ in range(3):
        out = {
            "logits_stack": rng.normal(size=(seeds, batch, 2, classes))
            .astype(np.float32),
            "label": rng.integers(0, classes, size=(seeds, batch)),
            "valid": (rng.random((seeds, batch)) < 0.8).astype(np.float32),
            "loss": rng.random(seeds).astype(np.float32),
            "acc": rng.random(seeds).astype(np.float32),
        }
        if contract == "ensemble":
            out.update(x1_acc=rng.random(seeds).astype(np.float32),
                       x2_acc=rng.random(seeds).astype(np.float32))
        if contract == "qmf":
            out["df_acc"] = rng.random(seeds).astype(np.float32)
        outputs.append(out)
    got = multiseed.multiseed_eval_summary(
        [{k: torch.from_numpy(v) for k, v in o.items()} for o in outputs],
        seeds, "val")
    want = jax_multiseed.multiseed_eval_summary(
        [{k: jnp.asarray(v) for k, v in o.items()} for o in outputs],
        seeds, "val")
    assert list(got) == list(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-6, atol=1e-7,
                                   err_msg=key)


class _TwinBench:
    """A seed-dependent AV-MNIST twin (per package) with the benchmark's
    model spec."""

    def __init__(self, splits, bundle, spec_module, uneven=False):
        self.splits, self.bundle = splits, bundle
        self.get_model_spec = spec_module.get_model_spec
        self.uneven = uneven

    def get_data(self, args):
        n_val = 16 + 8 * int(args.seed) if self.uneven else 16
        return self.bundle(*self.splits("avmnist", 4, seed=int(args.seed),
                                        n_train=32, n_val=n_val, n_test=16),
                           synthetic=True)


@pytest.mark.parametrize("overrides,uneven,match", [
    ({"overfit_batches": 1}, False, "overfit_batches is a single-run"),
    ({"pipeline_stages": 2}, False, "mesh-less"),
    ({"sequence_sharding": True}, False, "mesh-less"),
    ({}, True, "unequal split sizes"),
])
def test_refusals_use_jax_words(tmp_path, overrides, uneven, match):
    port_args = make_args(tmp_path, "port", **overrides)
    jax_args = make_args(tmp_path, "jax", **overrides)
    with pytest.raises(NotImplementedError, match=match):
        jax_multiseed.run_multiseed(
            jax_args, _TwinBench(jax_splits, JaxBundle, jax_avmnist, uneven),
            [0, 1])
    with pytest.raises(NotImplementedError, match=match):
        multiseed.run_multiseed(
            port_args, _TwinBench(make_synthetic_splits, DataBundle, avmnist,
                                  uneven), [0, 1], device="cpu")


@pytest.mark.parametrize("key", ["dist_init", "dist_coordinator"])
def test_multi_process_settings_refused(tmp_path, key):
    """The JAX sweep refuses a multi-process run; the port refuses the
    settings that would ask it for one."""
    args = make_args(tmp_path, "port", **{key: "tcp://localhost:1234"})
    with pytest.raises(NotImplementedError,
                       match="single-process sweep"):
        multiseed.run_multiseed(args, avmnist, [0, 1], device="cpu")


def test_per_seed_data_and_shared_data(tmp_path):
    """One ``get_data`` a seed with that seed, and each seed evaluated on
    its own val and test rows; ``multiseed_shared_data`` calls it once with
    the run's seed and broadcasts one eval batch to every seed."""
    calls = []
    bench = _TwinBench(make_synthetic_splits, DataBundle, avmnist)
    get_data = bench.get_data

    def counting(args):
        calls.append(int(args.seed))
        return get_data(args)

    bench.get_data = counting
    summary = multiseed.run_multiseed(
        make_args(tmp_path, "port", num_epochs=1), bench, [5, 9],
        device="cpu")
    assert calls == [5, 9]
    assert summary["test_epoch/test_avg_loss_seed0"] != summary[
        "test_epoch/test_avg_loss_seed1"]
    calls.clear()
    shared = make_args(tmp_path, "shared", num_epochs=1,
                       multiseed_shared_data=True)
    summary = multiseed.run_multiseed(shared, bench, [5, 9], device="cpu")
    assert calls == [0]
    assert np.isfinite(summary["test_epoch/test_avg_acc"])
