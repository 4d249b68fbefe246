"""One rank of the two-process gloo group of ``test_torch_port_parallel.py``.

    python tests/torch_port_parallel_worker.py RANK WORK_DIR

The test process writes ``WORK_DIR/inputs.pkl`` (the JAX inits' weights,
the global batches, the injected SpecAugment masks and OGM-GE noise) and
starts two of these.  Each starts the port's process group through
``parallel/distributed.py::initialize_if_requested`` over a ``file://``
store in ``WORK_DIR`` (no TCP port, so parallel test workers do not
collide), runs every case of the file on its rows, and writes what it
computed to ``WORK_DIR/rank{RANK}.pt`` for the test process to compare.
Imports nothing of JAX.
"""

from __future__ import annotations

import functools
import pickle
import sys
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

WORLD = 2


def _rows(array, rank):
    """This rank's rows of a global (WORLD * b, ...) array."""
    b = len(array) // WORLD
    return array[rank * b:(rank + 1) * b]


def _port(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def mesh_case():
    from multimodal_clinical_tpu_torch.parallel.mesh import make_mesh

    out = {"default": make_mesh().shape,
           "data2": make_mesh({"data": 2}).shape}
    for name, shape in (("model2", {"model": 2}),
                        ("stage2", {"data": 1, "stage": 2})):
        out[name] = make_mesh(shape).shape
    try:
        make_mesh({"data": 4})
        out["data4"] = None
    except ValueError as exc:
        out["data4"] = (type(exc).__name__, str(exc))
    return out


def _bn_pass(inp, rank, cls, group):
    """One train-mode pass of ``cls`` on this rank's rows of the global x:
    the output and input gradient rows, the parameters' gradients summed
    over ``group``, and the running statistics."""
    from multimodal_clinical_tpu_torch.engine.steps import sum_gradients

    bn = cls(inp["x"].shape[1], scale_std=0.0)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["scale"]))
        bn.bias.copy_(torch.from_numpy(inp["bias"]))
    x = torch.from_numpy(_rows(inp["x"], rank)).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    bn.train()
    y = bn(x)
    (y * torch.from_numpy(_rows(inp["w"], rank))).sum().backward()
    sum_gradients(bn, group)
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dscale": bn.weight.grad.numpy(), "dbias": bn.bias.grad.numpy(),
            "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}


def bn_case(inp, rank):
    """Both BatchNorms on this rank's rows, inside a step's data axis (the
    global batch's statistics) and outside any step (``local``: the
    rank's own, though the process group is up)."""
    from multimodal_clinical_tpu_torch.models.common import (
        FusedBatchNorm, TorchBatchNorm,
    )
    from multimodal_clinical_tpu_torch.parallel.distributed import data_axis
    from multimodal_clinical_tpu_torch.parallel.mesh import make_mesh

    group = make_mesh().data_group
    out = {}
    for name, cls in (("default", TorchBatchNorm), ("fused", FusedBatchNorm)):
        with data_axis(group):
            out[name] = _bn_pass(inp, rank, cls, group)
        out[f"local_{name}"] = _bn_pass(inp, rank, cls, None)
    return out


def draws_case():
    """A step's dropout masks and SpecAugment bands: drawn at the global
    batch's shape, this rank's rows kept."""
    from multimodal_clinical_tpu_torch.engine.state import step_generator
    from multimodal_clinical_tpu_torch.engine.steps import device_dropout
    from multimodal_clinical_tpu_torch.ops.specaugment import (
        spec_augment_masks,
    )

    from multimodal_clinical_tpu_torch.parallel.distributed import data_axis
    from multimodal_clinical_tpu_torch.parallel.mesh import make_mesh

    def draws():
        keep = device_dropout(3, 5)((4, 6), 0.5, torch.device("cpu"))
        fmask, tmask = spec_augment_masks(step_generator(3, 5), 4, 40, 60,
                                          "cpu")
        return {"keep": keep.numpy(), "fmask": fmask.numpy(),
                "tmask": tmask.numpy()}

    with data_axis(make_mesh().data_group):
        out = draws()
    out["local"] = draws()  # outside a step: this rank's 4 rows alone
    return out


def _narrow_steps(mp, inp):
    """The narrow towers of the contract harness, switched as asked."""
    from multimodal_clinical_tpu_torch.benchmarks import cremad, vggsound
    from multimodal_clinical_tpu_torch.models import zoo
    from multimodal_clinical_tpu_torch.models.resnet import ResNetEncoder

    port_mod = {"cremad": cremad, "vggsound": vggsound}[inp["bench"]]
    mp.setattr(zoo, "ResNetEncoder", functools.partial(
        ResNetEncoder, stage_sizes=inp["stages"], **inp["switches"]))
    mp.setattr(port_mod, "CremadFusionNet", functools.partial(
        zoo.CremadFusionNet, width=inp["width"]))
    return port_mod


def step_case(inp, rank, fsdp=False, ckpt_dir=None):
    """Two train steps of one contract on this rank's rows of each global
    batch, from the JAX init's weights, then one eval step; with ``fsdp``
    under FSDP (leaves of at least ``fsdp`` elements sharded) and the
    state saved to ``ckpt_dir``."""
    from multimodal_clinical_tpu_torch.engine.checkpoint import (
        BestCheckpointer, state_to_tree,
    )
    from multimodal_clinical_tpu_torch.engine.state import create_train_state
    from multimodal_clinical_tpu_torch.engine.steps import (
        make_eval_step, make_train_step,
    )
    from multimodal_clinical_tpu_torch.models.jax_weights import (
        load_jax_variables,
    )
    from multimodal_clinical_tpu_torch.parallel import sharding
    from multimodal_clinical_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cudnn.allow_tf32 = False
    with pytest.MonkeyPatch.context() as mp:
        port_mod = _narrow_steps(mp, inp)
        args = SimpleNamespace(**inp["args"])
        spec, _ = port_mod.get_model_spec(args, n_train=inp["n_train"])
        state = create_train_state(spec, args, seed=0, steps_per_epoch=100,
                                   device="cpu")
        load_jax_variables(state.model, inp["params"], inp["stats"])
        if fsdp:
            mp.setattr(sharding, "_FSDP_MIN_SIZE", fsdp)
        state = sharding.place_state(state, make_mesh(), fsdp=bool(fsdp))
        drawn = []

        def masks(*a, **k):
            fmask, tmask = inp["masks"][len(drawn)]
            drawn.append(1)
            return (torch.from_numpy(_rows(fmask, rank).copy()),
                    torch.from_numpy(_rows(tmask, rank).copy()))

        if hasattr(port_mod, "spec_augment_masks"):
            mp.setattr(port_mod, "spec_augment_masks", masks)
        noise = {k: torch.from_numpy(v) for k, v in inp["noise"].items()}
        train = make_train_step(
            spec, ogm_noise=lambda _: lambda name, g: noise[name])
        metrics, shards = [], None
        for batch in inp["batches"]:
            local = _port({k: _rows(v, rank) for k, v in batch.items()})
            state, m = train(state, local)
            metrics.append({k: float(v) for k, v in m.items()})
            if state.sharded is not None and shards is None:
                shards = {name: (tuple(leaf.shard.shape), leaf.shape,
                                 tuple(state.optimizer.state[leaf.shard][
                                     "momentum_buffer"].shape))
                          for name, leaf in zip(
                              [n for n, p in state.model.named_parameters()
                               if any(p is leaf.param
                                      for leaf in state.sharded.leaves)],
                              state.sharded.leaves)}
        evaluated = {k: _rows(v, rank) for k, v in inp["batches"][-1].items()}
        out = {k: v.numpy() for k, v in make_eval_step(spec)(
            state, _port(evaluated)).items()}
        tree = state_to_tree(state)
        if ckpt_dir is not None:
            BestCheckpointer(ckpt_dir).save_last(state, epochs_done=1,
                                                 steps_per_epoch=2)
    return {"metrics": metrics, "out": out, "shards": shards,
            "model": {k: v.numpy() for k, v in tree["model"].items()},
            "optimizer": tree["optimizer"], "ema": tree["ema"].numpy(),
            "step": tree["step"],
            "qmf": None if tree["qmf_correctness"] is None else (
                tree["qmf_correctness"].numpy(),
                tree["qmf_confidence"].numpy()),
            "masks_drawn": len(drawn)}


def cli_case(inp, work, rank):
    """The VGGSound CLI on its narrowed twin for one epoch, the rank's
    feed recorded; the trainer's writer flags."""
    import multimodal_clinical_tpu_torch.__main__ as cli
    import multimodal_clinical_tpu_torch.data.synthetic as syn
    from multimodal_clinical_tpu_torch.benchmarks import vggsound
    from multimodal_clinical_tpu_torch.data import loader as loader_mod
    from multimodal_clinical_tpu_torch.engine import run
    from multimodal_clinical_tpu_torch.models import zoo
    from multimodal_clinical_tpu_torch.models.resnet import ResNetEncoder

    fed, seen = [], {}
    host_batches = loader_mod.Loader._host_batches

    def recording(self):
        for batch in host_batches(self):
            fed.append((len(self.dataset), batch["idx"].numpy().copy(),
                        batch["valid"].numpy().copy()))
            yield batch

    class Seen(run.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["writes"] = (self.logger.write, self.ckpt._primary)

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(syn.BENCHMARK_SHAPES, "vggsound", inp["shapes"])
        mp.setattr(zoo, "ResNetEncoder", functools.partial(
            ResNetEncoder, stage_sizes=(1, 1, 1, 1)))
        mp.setattr(vggsound, "CremadFusionNet", functools.partial(
            zoo.CremadFusionNet, width=inp["width"]))
        mp.setattr(loader_mod.Loader, "_host_batches", recording)
        mp.setattr(run, "Trainer", Seen)
        argv = [*inp["argv"], "--set", f"ckpt_dir={work / 'cli'}",
                "--set", f"data_path={work / 'none'}",
                "--set", f"dist_coordinator=file://{work / 'store'}",
                "--set", f"dist_num_processes={WORLD}",
                "--set", f"dist_process_id={rank}",
                "--set", "mesh_shape={data: 2}"]
        summary = cli.run_training(argv, device="cpu")
    return {"summary": summary, "fed": fed, "writes": seen["writes"]}


def streams_case(rank):
    """Each split's sampler stream as ``build_loaders`` gives this rank,
    for 13 rows (wrap-padded to 14)."""
    from multimodal_clinical_tpu_torch.data.core import ArrayDataset
    from multimodal_clinical_tpu_torch.engine import run
    from multimodal_clinical_tpu_torch.parallel.mesh import make_mesh

    labels = (np.arange(13) % 3).astype(np.int32)
    split = ArrayDataset([np.zeros((13, 2), np.float32)], labels)
    data = run.DataBundle(split, split, split, train_sampler="weighted",
                          val_sampler="random", test_sampler="sequential")
    args = SimpleNamespace(batch_size=4, seed=5, loader_workers=1)
    loaders = run.build_loaders(args, data, "cpu", make_mesh())
    out = {kind: [loader.sampler.indices(e) for e in (0, 1)]
           for kind, loader in zip(("weighted", "random", "sequential"),
                                   loaders)}
    out["batch_size"] = loaders[0].batch_size
    for bs in (5, 7):
        try:
            run.build_loaders(SimpleNamespace(batch_size=bs, seed=0), data,
                              "cpu", make_mesh())
            out[f"bs{bs}"] = None
        except ValueError as exc:
            out[f"bs{bs}"] = str(exc)
    return out


# the benchmarks' CLIs on two ranks under FSDP, each narrowed as its own
# CLI test narrows it; VGGSound is ``cli_case``'s
BENCHMARK_CLIS = ("avmnist", "mimic", "mustard", "cremad", "ave", "enrico",
                  "fakenews", "food101", "food101_legacy")


def benchmarks_case(work, rank):
    """Every benchmark's twin through the CLI for one epoch on the two
    ranks, with ``mesh_shape: {data: 2}`` and ``fsdp: true`` (leaves of at
    least 1024 elements sharded at these widths): the summary, and how
    many leaves FSDP sharded."""
    import multimodal_clinical_tpu_torch.__main__ as cli
    import multimodal_clinical_tpu_torch.data.synthetic as syn
    from multimodal_clinical_tpu_torch.benchmarks import ave, cremad
    from multimodal_clinical_tpu_torch.engine import run
    from multimodal_clinical_tpu_torch.models import zoo
    from multimodal_clinical_tpu_torch.models.resnet import ResNetEncoder
    from multimodal_clinical_tpu_torch.parallel import sharding

    import torch_port_benchmark_harness as BH

    out = {}
    for bench in BENCHMARK_CLIS:
        seen = {}

        class Seen(run.Trainer):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                seen["sharded"] = (0 if self.state.sharded is None
                                   else len(self.state.sharded.leaves))

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sharding, "_FSDP_MIN_SIZE", 1024)
            mp.setattr(run, "Trainer", Seen)
            if bench in ("cremad", "ave"):
                mp.setitem(syn.BENCHMARK_SHAPES, bench,
                           [(17, 20, 1), (2, 16, 16, 3)])
                mp.setattr(zoo, "ResNetEncoder", functools.partial(
                    ResNetEncoder, stage_sizes=(1, 1, 1, 1)))
                mod = {"cremad": cremad, "ave": ave}[bench]
                mp.setattr(mod, "CremadFusionNet", functools.partial(
                    zoo.CremadFusionNet, width=4))
            else:
                BH.narrow(bench, mp)
            argv = ["--dir", BH._module_name(bench), "--set", "num_epochs=1",
                    "--set", "compute_dtype=float32", "--set", "fsdp=True",
                    "--set", "mesh_shape={data: 2}",
                    "--set", f"ckpt_dir={work / 'benchmarks' / bench}",
                    "--set", f"data_path={work / 'none'}",
                    *BH.CLI_SETS.get(bench, ()),
                    *(("--set", "model_type=jprobas")
                      if bench == "food101_legacy" else ())]
            try:
                summary = cli.run_training(argv, device="cpu")
                out[bench] = {"summary": summary, **seen}
            except Exception:
                out[bench] = {"error": traceback.format_exc()}
    return out


def refusal_case(inp, work):
    """A multi-process ``num_seeds > 1`` run is refused."""
    import multimodal_clinical_tpu_torch.__main__ as cli

    try:
        cli.run_training([*inp["argv"], "--set", "num_seeds=2",
                          "--set", f"data_path={work / 'none'}"],
                         device="cpu")
    except NotImplementedError as exc:
        return str(exc)
    return None


def _wait_for(path: Path, timeout: float = 600.0):
    """The pickle at ``path`` once the test process has written it."""
    import time

    deadline = time.monotonic() + timeout
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} not written")
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def _run(cases, out):
    for name, case in cases.items():
        try:
            out[name] = case()
        except Exception:  # reported to the test, which fails on it
            out[name] = {"error": traceback.format_exc()}


def main(rank: int, work: Path) -> None:
    torch.set_num_threads(2)
    from multimodal_clinical_tpu_torch.parallel import distributed

    device = distributed.initialize_if_requested(SimpleNamespace(
        dist_coordinator=f"file://{work / 'store'}",
        dist_num_processes=WORLD, dist_process_id=rank), "cpu")
    with open(work / "inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    out = {"device": str(device), "backend": distributed.backend(),
           "world": distributed.world_size(), "rank": distributed.rank()}
    cases = {
        "mesh": mesh_case,
        "bn": lambda: bn_case(inp["bn"], rank),
        "draws": draws_case,
        "streams": lambda: streams_case(rank),
        "cli": lambda: cli_case(inp["cli"], work, rank),
        "benchmarks": lambda: benchmarks_case(work, rank),
        "refusal": lambda: refusal_case(inp["cli"], work),
    }
    _run(cases, out)
    # the step cases need the JAX inits' weights, which the test process
    # writes to steps.pkl while the cases above run
    steps = _wait_for(work / "steps.pkl")
    cases = {f"step_{name}": functools.partial(step_case, case, rank)
             for name, case in steps["steps"].items()}
    cases["fsdp"] = lambda: step_case(steps["steps"]["jprobas"], rank,
                                      fsdp=steps["fsdp_min_size"],
                                      ckpt_dir=work / "fsdp_ckpt")
    _run(cases, out)
    torch.save(out, work / f"rank{rank}.pt")
    distributed.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), Path(sys.argv[2]))
