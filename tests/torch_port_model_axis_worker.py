"""One rank of the four-process gloo groups of
``test_torch_port_tensor_parallel.py`` (``tp``) and
``test_torch_port_pipeline.py`` (``pp``).

    python tests/torch_port_model_axis_worker.py RANK WORK_DIR SET

The test process writes ``WORK_DIR/inputs.pkl`` (the JAX inits' weights,
the global batches, the injected dropout masks and OGM-GE noise) and
starts four of these.  Each starts the port's process group over a
``file://`` store in ``WORK_DIR``, runs the SET's cases on its data
coordinate's rows under each case's mesh, and writes what it computed to
``WORK_DIR/rank{RANK}.pt``.  Imports nothing of JAX.
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

WORLD = 4
# the narrowed SigLIP of the benchmark harness
SIGLIP_TINY = dict(width=64, layers=2, heads=2, mlp_dim=128, patch=16,
                   image_size=32, text_len=16, vocab=1000)


def _rows(array, coord, parts=2):
    """Data coordinate ``coord``'s rows of a global (parts * b, ...)
    array."""
    b = len(array) // parts
    return array[coord * b:(coord + 1) * b]


def _port(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _dropout_source(global_b: int, coord: int, n: int):
    """The harness's injected dropout masks (``dropout_mask``), drawn at
    the global batch's shape, this data coordinate's rows kept."""
    def per_step(state):
        count = [0]

        def source(shape, keep_prob, device):
            full = (global_b,) + tuple(shape[1:])
            mask = np.random.default_rng(500 + count[0] % n).random(
                full) < keep_prob
            count[0] += 1
            return torch.from_numpy(_rows(mask, coord)).to(device)

        return source

    return per_step


def mesh_case():
    from multimodal_clinical_tpu_torch.parallel.mesh import (
        DATA_AXIS, MODEL_AXIS, STAGE_AXIS, make_mesh,
    )
    from multimodal_clinical_tpu_torch.parallel import distributed

    out = {}
    for name, shape in (("dm", {"data": 2, "model": 2}),
                        ("ds", {"data": 2, "stage": 2}),
                        ("m4", {"model": 4}),
                        ("dms", {"data": 1, "model": 2, "stage": 2})):
        mesh = make_mesh(shape)
        out[name] = dict(
            shape=mesh.shape,
            coords={a: mesh.coordinate(a) for a in mesh.shape},
            sizes={a: distributed.group_size(mesh.group(a))
                   for a in (DATA_AXIS, MODEL_AXIS, STAGE_AXIS)},
            ranks={a: (None if mesh.group(a) is None else sorted(
                torch.distributed.get_process_group_ranks(mesh.group(a))))
                   for a in (DATA_AXIS, MODEL_AXIS, STAGE_AXIS)})
    try:
        make_mesh({"model": 3})
        out["m3"] = None
    except ValueError as exc:
        out["m3"] = str(exc)
    return out


def feed_case():
    """Each split's sampler stream as ``build_loaders`` gives this rank
    under ``{data: 2, model: 2}``, for 13 rows."""
    from multimodal_clinical_tpu_torch.data.core import ArrayDataset
    from multimodal_clinical_tpu_torch.engine import run
    from multimodal_clinical_tpu_torch.parallel.mesh import (
        batch_sharding, make_mesh,
    )

    mesh = make_mesh({"data": 2, "model": 2})
    labels = (np.arange(13) % 3).astype(np.int32)
    split = ArrayDataset([np.zeros((13, 2), np.float32)], labels)
    data = run.DataBundle(split, split, split, train_sampler="weighted",
                          val_sampler="random", test_sampler="sequential")
    args = SimpleNamespace(batch_size=4, seed=5, loader_workers=1)
    loaders = run.build_loaders(args, data, "cpu", mesh)
    out = {kind: [loader.sampler.indices(e) for e in (0, 1)]
           for kind, loader in zip(("weighted", "random", "sequential"),
                                   loaders)}
    out["batch_size"] = loaders[0].batch_size
    out["rows"] = batch_sharding(mesh, 8)
    return out


def _full_grads(state):
    """Every parameter's gradient, whole (a sharded leaf's compute block
    gathered over its axes)."""
    by_name = {} if state.sharded is None else {
        leaf.name: leaf for leaf in state.sharded.leaves}
    out = {}
    for name, p in state.model.named_parameters():
        if p.grad is None:
            continue
        g = p.grad.detach()
        if name in by_name:
            g = by_name[name].gather(g, by_name[name].compute)
        out[name] = g.numpy().copy()
    return out


def _held(state):
    """What this rank holds of each sharded leaf: (its module parameter's
    shape, its shard's, the full leaf's, its momentum's)."""
    if state.sharded is None:
        return {}
    return {leaf.name: (tuple(leaf.param.shape), tuple(leaf.shard.shape),
                        leaf.shape, tuple(state.optimizer.state.get(
                            leaf.shard, {}).get(
                                "momentum_buffer",
                                torch.empty(0)).shape))
            for leaf in state.sharded.leaves}


def _tree(state):
    from multimodal_clinical_tpu_torch.engine.checkpoint import state_to_tree

    tree = state_to_tree(state)
    return {"model": {k: v.numpy() for k, v in tree["model"].items()},
            "optimizer": tree["optimizer"], "ema": tree["ema"].numpy(),
            "step": tree["step"]}


def _save(state, ckpt_dir):
    from multimodal_clinical_tpu_torch.engine.checkpoint import (
        BestCheckpointer,
    )

    BestCheckpointer(ckpt_dir).save_last(state, epochs_done=1,
                                         steps_per_epoch=2)


def _narrow_cremad(mp, inp):
    from multimodal_clinical_tpu_torch.benchmarks import cremad
    from multimodal_clinical_tpu_torch.models import zoo
    from multimodal_clinical_tpu_torch.models.resnet import ResNetEncoder

    mp.setattr(zoo, "ResNetEncoder", functools.partial(
        ResNetEncoder, stage_sizes=inp["stages"], **inp["switches"]))
    mp.setattr(cremad, "CremadFusionNet", functools.partial(
        zoo.CremadFusionNet, width=inp["width"]))
    return cremad


def _narrow_siglip(mp):
    from multimodal_clinical_tpu_torch.models import siglip

    mp.setattr(siglip, "SigLIPModel", functools.partial(
        siglip.SigLIPModel, **SIGLIP_TINY))


def _state(bench_mod, inp, mesh, takes_mesh=False):
    from multimodal_clinical_tpu_torch.engine.state import create_train_state
    from multimodal_clinical_tpu_torch.models.jax_weights import (
        load_jax_variables,
    )
    from multimodal_clinical_tpu_torch.parallel.sharding import place_state

    args = SimpleNamespace(**inp["args"])
    spec, _ = bench_mod.get_model_spec(args, n_train=inp["n_train"],
                                       **({"mesh": mesh} if takes_mesh
                                          else {}))
    state = create_train_state(spec, args, seed=0, steps_per_epoch=100,
                               device="cpu")
    load_jax_variables(state.model, inp["params"], inp["stats"])
    return spec, place_state(state, mesh)


def cremad_case(inp, work):
    """Crema-D ogm_ge on ``{data: 2, model: 2}``: the two train steps of
    ``test_torch_port_parallel.py``'s case on this data coordinate's rows,
    its OGM-GE noise and front end; the state saved."""
    from multimodal_clinical_tpu_torch.engine.steps import make_train_step
    from multimodal_clinical_tpu_torch.parallel.mesh import (
        DATA_AXIS, make_mesh,
    )

    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh({"data": 2, "model": 2})
    coord = mesh.coordinate(DATA_AXIS)
    with pytest.MonkeyPatch.context() as mp:
        bench = _narrow_cremad(mp, inp)
        spec, state = _state(bench, inp, mesh)
        noise = {k: torch.from_numpy(v) for k, v in inp["noise"].items()}
        train = make_train_step(
            spec, ogm_noise=lambda _: lambda name, g: noise[name])
        metrics = []
        for batch in inp["batches"]:
            state, m = train(state, _port({k: _rows(v, coord)
                                           for k, v in batch.items()}))
            metrics.append({k: float(v) for k, v in m.items()})
        _save(state, work / "ckpt_cremad")
        return {"metrics": metrics, "held": _held(state), **_tree(state)}


def mimic_case(inp, work):
    """MIMIC jlogits on ``{data: 2, model: 2}``: the benchmark harness's
    two train steps (the second with a padded tail) with its dropout masks
    injected; the state saved."""
    from multimodal_clinical_tpu_torch.benchmarks import mimic
    from multimodal_clinical_tpu_torch.engine.steps import make_train_step
    from multimodal_clinical_tpu_torch.parallel.mesh import (
        DATA_AXIS, make_mesh,
    )

    mesh = make_mesh({"data": 2, "model": 2})
    coord = mesh.coordinate(DATA_AXIS)
    spec, state = _state(mimic, inp, mesh)
    train = make_train_step(spec, dropout=_dropout_source(
        len(inp["batches"][0]["label"]), coord, inp["n_dropouts"]))
    metrics = []
    for batch in inp["batches"]:
        state, m = train(state, _port({k: _rows(v, coord)
                                       for k, v in batch.items()}))
        metrics.append({k: float(v) for k, v in m.items()})
    _save(state, work / "ckpt_mimic")
    return {"metrics": metrics, "held": _held(state), **_tree(state)}


def food_step_case(inp, work, tag, mesh_shape):
    """Food101 jlogits (the narrowed SigLIP) on ``mesh_shape``: two train
    steps (the second with a padded tail) with the injected dropout
    masks, counting the blocks' gathers of the sequence and keeping the
    attention key biases' gradients (zero in exact arithmetic); the
    state saved."""
    from multimodal_clinical_tpu_torch.benchmarks import food101
    from multimodal_clinical_tpu_torch.engine.steps import make_train_step
    from multimodal_clinical_tpu_torch.models import siglip
    from multimodal_clinical_tpu_torch.parallel import distributed
    from multimodal_clinical_tpu_torch.parallel.mesh import (
        DATA_AXIS, make_mesh,
    )

    mesh = make_mesh(mesh_shape)
    coord = mesh.coordinate(DATA_AXIS)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        _narrow_siglip(mp)
        gather = siglip.gather_partial
        mp.setattr(siglip, "gather_partial",
                   lambda *a: calls.append(1) or gather(*a))
        spec, state = _state(food101, inp, mesh, takes_mesh=True)
        train = make_train_step(spec, dropout=_dropout_source(
            len(inp["batch"]["label"]), coord, inp["n_dropouts"]))
        metrics, grads = [], []
        for batch in inp["batches"]:
            state, m = train(state, _port({k: _rows(v, coord)
                                           for k, v in batch.items()}))
            metrics.append({k: float(v) for k, v in m.items()})
            grads.append({k: g for k, g in _full_grads(state).items()
                          if k.endswith(".k_proj.bias")})
    _save(state, work / f"ckpt_{tag}")
    return {"metrics": metrics, "grads": grads,
            "held": _held(state), "sequence_gathers": len(calls),
            "backend": distributed.backend(), **_tree(state)}


def food_grads_case(inp):
    """Food101 (narrowed SigLIP, two GPipe stages, 4 microbatches) on
    ``{data: 2, stage: 2}`` in eval mode: the forward's logits on this
    data coordinate's rows, and every leaf's gradient of the jlogits loss
    on the global batch, whole."""
    from multimodal_clinical_tpu_torch.benchmarks import food101
    from multimodal_clinical_tpu_torch.engine import contracts as C
    from multimodal_clinical_tpu_torch.engine.steps import (
        global_batch, sum_gradients,
    )
    from multimodal_clinical_tpu_torch.parallel.distributed import data_axis
    from multimodal_clinical_tpu_torch.parallel.mesh import (
        DATA_AXIS, make_mesh,
    )

    mesh = make_mesh({"data": 2, "stage": 2})
    coord = mesh.coordinate(DATA_AXIS)
    with pytest.MonkeyPatch.context() as mp:
        _narrow_siglip(mp)
        spec, state = _state(food101, inp, mesh, takes_mesh=True)
    batch = _port({k: _rows(v, coord) for k, v in inp["batch"].items()})
    model = state.model.eval()
    with data_axis(state.data_axis):
        out = model(batch["x1"], batch["x2"])
        gb, gout = global_batch(batch, out, state.data_axis)
        loss = C.cross_entropy(C.fuse_logits(gout["logits"]), gb["label"],
                               gb["valid"])
        loss.backward()
        sum_gradients(model, state.data_axis)
    return {"logits": [l.detach().numpy() for l in out["logits"]],
            "loss": float(loss), "grads": _full_grads(state),
            "held": _held(state)}


def cli_case(work, rank, tag, sets):
    """The Food101 CLI (the narrowed SigLIP and twin of the benchmark
    harness) for one epoch on the four ranks with ``sets``."""
    import multimodal_clinical_tpu_torch.__main__ as cli
    import multimodal_clinical_tpu_torch.data.synthetic as syn

    with pytest.MonkeyPatch.context() as mp:
        _narrow_siglip(mp)
        mp.setitem(syn.BENCHMARK_SHAPES, "food101", [(16,), (32, 32, 3)])
        argv = ["--dir", "food101", "--set", "num_epochs=1",
                "--set", "model_type=jlogits",
                "--set", "compute_dtype=float32",
                "--set", f"ckpt_dir={work / 'cli' / tag}",
                "--set", f"data_path={work / 'none'}",
                "--set", f"dist_coordinator=file://{work / 'store'}",
                "--set", f"dist_num_processes={WORLD}",
                "--set", f"dist_process_id={rank}", *sets]
        return {"summary": cli.run_training(argv, device="cpu")}


def _run(cases, out):
    for name, case in cases.items():
        try:
            out[name] = case()
        except Exception:  # reported to the test, which fails on it
            out[name] = {"error": traceback.format_exc()}


def _wait_for(path: Path, timeout: float = 600.0):
    import time

    deadline = time.monotonic() + timeout
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} not written")
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def main(rank: int, work: Path, which: str) -> None:
    torch.set_num_threads(1)
    from multimodal_clinical_tpu_torch.parallel import distributed

    # the port's modules name their flax layouts before the tests narrow
    # SigLIP (``jax_weights`` binds the class at import)
    import multimodal_clinical_tpu_torch.models.jax_weights  # noqa: F401

    distributed.initialize_if_requested(SimpleNamespace(
        dist_coordinator=f"file://{work / 'store'}",
        dist_num_processes=WORLD, dist_process_id=rank), "cpu")
    out = {"rank": distributed.rank(), "backend": distributed.backend()}
    if which == "tp":
        _run({"mesh": mesh_case, "feed": feed_case}, out)
    inp = _wait_for(work / "inputs.pkl")
    if which == "tp":
        cases = {"cremad": lambda: cremad_case(inp["cremad"], work),
                 "mimic": lambda: mimic_case(inp["mimic"], work)}
    else:
        cases = {
            "sp": lambda: food_step_case(inp["food"], work, "sp", {
                "data": 2, "model": 2}),
            "pp_grads": lambda: food_grads_case(inp["food_pp"]),
            "pp": lambda: food_step_case(inp["food_pp"], work, "pp", {
                "data": 2, "stage": 2}),
            "cli_sp": lambda: cli_case(work, rank, "sp", (
                "--set", "mesh_shape={data: 2, model: 2}",
                "--set", "sequence_sharding=True")),
            "cli_pp": lambda: cli_case(work, rank, "pp", (
                "--set", "mesh_shape={data: 2, stage: 2}",
                "--set", "pipeline_stages=2")),
        }
    _run(cases, out)
    torch.save(out, work / f"rank{rank}.pt")
    distributed.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), Path(sys.argv[2]), sys.argv[3])
