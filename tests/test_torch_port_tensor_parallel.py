"""The port's model axis (tensor parallelism) and its mesh over four ranks,
against the JAX package on the same mesh, on the CPU.

One four-process gloo group serves the file: the module fixture starts
four ``torch_port_model_axis_worker.py`` processes (set ``tp``) over a
``file://`` store, computes the JAX inits and the inputs meanwhile,
writes them to ``tmp_path``, runs JAX's steps on its ``{data: 2, model:
2}`` mesh of four CPU devices (its TP rules placing the state), and
collects what each rank wrote.  Crema-D ogm_ge is
``test_torch_port_parallel.py``'s case (two steps, the second with each
data coordinate's shard padded, its OGM-GE noise and front ends); MIMIC
jlogits the benchmark harness's two steps (the second with a padded
tail) with its dropout masks injected.

Tolerances.  The mesh, the feed, what each rank holds, the ranks against
each other and the checkpoints' round trips are exact.  The steps are
held as ``test_torch_port_parallel.py`` holds the data axis against JAX
(``torch_port_contract_harness.py``: losses 1e-5 relative, parameter
updates and momentum 3e-4 of each tensor's largest entry, BN buffers
1e-4 relative and 1e-5 absolute, the EMA 1e-5): a column-parallel Dense
computes its output block by block and sums its input gradient over the
model axis, one more reordering of the same fp32 terms.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.benchmarks import mimic as jax_mimic
from multimodal_clinical_tpu.data import sampler as jax_sampler
from multimodal_clinical_tpu.engine.state import (
    create_train_state as jax_create_train_state,
)
from multimodal_clinical_tpu.engine.steps import (
    make_train_step as jax_make_train_step,
)
from multimodal_clinical_tpu.models import zoo as jax_zoo
from multimodal_clinical_tpu.parallel import mesh as jax_mesh
from multimodal_clinical_tpu.parallel import sharding as jax_sharding

from multimodal_clinical_tpu_torch.benchmarks import mimic
from multimodal_clinical_tpu_torch.engine.checkpoint import BestCheckpointer
from multimodal_clinical_tpu_torch.engine.state import create_train_state
from multimodal_clinical_tpu_torch.models.jax_weights import (
    get_leaf, jax_key_map, load_jax_variables,
)

import test_torch_port_parallel as P
import torch_port_benchmark_harness as BH
import torch_port_contract_harness as H

torch.set_num_threads(2)

TESTS = Path(__file__).resolve().parent
WORLD = 4
MESH = {"data": 2, "model": 2}


def _jax_mesh(shape=MESH):
    return jax_mesh.make_mesh(shape, devices=jax.devices()[:WORLD])


def _mimic_inputs():
    """The JAX init of MIMIC jlogits and its inputs."""
    args = BH._args("mimic", "jlogits")
    jspec, _ = jax_mimic.get_model_spec(args, n_train=BH.N_TRAIN)
    batches = BH.batches("mimic")
    sample = [jax.numpy.asarray(batches[0][f"x{i + 1}"][:2])
              for i in range(2)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_zoo.MimicFusionNet, "init", H._cached_init(
            "tp mimic", jax_zoo.MimicFusionNet.init, H.FAST_INIT))
        jstate = jax_create_train_state(jspec, args, jax.random.PRNGKey(0),
                                        sample, steps_per_epoch=100)
    spec, _ = mimic.get_model_spec(args, n_train=BH.N_TRAIN)
    n = BH.count_dropouts(spec.module)
    return jspec, jstate, dict(
        args=vars(args), n_train=BH.N_TRAIN, batches=batches, n_dropouts=n,
        params=jax.tree_util.tree_map(np.asarray, jstate.params),
        stats=jax.tree_util.tree_map(np.asarray, jstate.batch_stats))


def _run_jax_mimic(jspec, jstate, inp):
    mesh_ = _jax_mesh()
    with pytest.MonkeyPatch.context() as mp:
        BH.patch_dropout(mp, inp["n_dropouts"])
        jstate = jax_sharding.place_state(jstate, mesh_)
        jtrain = jax_make_train_step(jspec)
        jmetrics = []
        for batch in inp["batches"]:
            jstate, jm = jtrain(jstate, jax_mesh.put_batch(
                H._to_jax(batch), mesh_))
            jmetrics.append({k: float(v) for k, v in jm.items()})
    return dict(jstate=jstate, jmetrics=jmetrics)


def _run_jax_cremad(jspec, jstate, inp):
    """``test_torch_port_parallel.py``'s two Crema-D ogm_ge steps on the
    ``{data: 2, model: 2}`` mesh."""
    mesh_ = _jax_mesh()
    with pytest.MonkeyPatch.context() as mp:
        P._narrow(mp, "cremad", {})
        noise = inp["jax_noise"]
        calls = []

        def normal(key, shape, dtype=jax.numpy.float32):
            path, arr = noise[len(calls) % len(noise)]
            calls.append(path)
            return jax.numpy.asarray(arr, dtype)

        H.patch_ogm_normal(mp, normal)
        P._patch_front_ends(mp, inp["batches"])
        jstate = jax_sharding.place_state(jstate, mesh_)
        jtrain = jax_make_train_step(jspec)
        jmetrics = []
        for batch in inp["batches"]:
            jstate, jm = jtrain(jstate, jax_mesh.put_batch(
                H._to_jax(batch), mesh_))
            jmetrics.append({k: float(v) for k, v in jm.items()})
    return dict(jstate=jstate, jmetrics=jmetrics, noise_calls=len(calls))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The four ranks' results and JAX's runs on the same mesh."""
    work = tmp_path_factory.mktemp("tensor_parallel")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(TESTS.parent), str(TESTS), os.environ.get("PYTHONPATH", "")])}
    logs = [open(work / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(TESTS / "torch_port_model_axis_worker.py"),
         str(r), str(work), "tp"], stdout=logs[r], stderr=subprocess.STDOUT,
        env=env, cwd=TESTS.parent) for r in range(WORLD)]
    try:
        jspec_c, jstate_c = P._jax_init("ogm_ge")
        cremad = P._step_inputs("ogm_ge", jstate_c)
        jspec_m, jstate_m, mimic_inp = _mimic_inputs()
        inputs = {"cremad": {k: v for k, v in cremad.items()
                             if k != "jax_noise"}, "mimic": mimic_inp}
        with open(work / "inputs.pkl.part", "wb") as f:
            pickle.dump(inputs, f)
        os.replace(work / "inputs.pkl.part", work / "inputs.pkl")
        jax_runs = {"cremad": _run_jax_cremad(jspec_c, jstate_c, cremad),
                    "mimic": _run_jax_mimic(jspec_m, jstate_m, mimic_inp)}
        for proc in procs:
            proc.wait(timeout=600)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()
    codes = [p.returncode for p in procs]
    assert codes == [0] * WORLD, (codes, [(work / f"rank{r}.log").read_text()[
        -4000:] for r in range(WORLD)])
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return dict(work=work, ranks=ranks, inputs=inputs, jax=jax_runs,
                cremad=cremad)


def _result(group, case, rank=0):
    out = group["ranks"][rank][case]
    assert not (isinstance(out, dict) and "error" in out), out.get("error")
    return out


def test_mesh_places_ranks_as_jax_places_devices(group):
    """Each mesh over the four ranks: the axis sizes of JAX's mesh over
    four devices, each rank's coordinates where JAX's ``reshape(dp, mp,
    pp)`` puts device r, each axis's group the ranks JAX's array holds
    along that axis; a shape the ranks cannot form raises JAX's error."""
    shapes = {"dm": {"data": 2, "model": 2}, "ds": {"data": 2, "stage": 2},
              "m4": {"model": 4}, "dms": {"data": 1, "model": 2, "stage": 2}}
    for name, shape in shapes.items():
        jm = _jax_mesh(shape)
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        for r in range(WORLD):
            got = _result(group, "mesh", r)[name]
            assert got["shape"] == dict(jm.shape), (name, got["shape"])
            where = dict(zip(jm.axis_names, np.argwhere(ids == r)[0]))
            assert got["coords"] == {a: int(where[a]) for a in got["shape"]}
            for axis, size in jm.shape.items():
                index = [where[a] if a != axis else slice(None)
                         for a in jm.axis_names]
                members = sorted(ids[tuple(index)].ravel().tolist())
                assert got["sizes"][axis] == size, (name, axis)
                assert got["ranks"][axis] == (members if size > 1 else None)
    with pytest.raises(ValueError) as exc:
        _jax_mesh({"model": 3})
    assert _result(group, "mesh")["m3"] == str(exc.value)
    assert group["ranks"][0]["backend"] == "gloo"


def test_feed_gives_one_data_coordinate_the_same_rows(group):
    """Under ``{data: 2, model: 2}`` each rank's stream of every split is
    the JAX sampler's for its data coordinate's host shard (of two); the
    two model ranks of a data coordinate take the same rows, half the
    batch each, and its slice of a global batch (JAX's ``P("data")``)."""
    labels = (np.arange(13) % 3).astype(np.int32)
    jax_samplers = {
        "weighted": lambda d: jax_sampler.WeightedSampler(
            labels, seed=5, process_index=d, process_count=2),
        "random": lambda d: jax_sampler.RandomSampler(
            13, seed=6, process_index=d, process_count=2),
        "sequential": lambda d: jax_sampler.SequentialSampler(
            13, process_index=d, process_count=2)}
    for r in range(WORLD):
        got = _result(group, "feed", r)
        d = r // 2
        for kind, make in jax_samplers.items():
            for epoch in (0, 1):
                assert np.array_equal(got[kind][epoch],
                                      make(d).indices(epoch)), (kind, r)
        assert got["batch_size"] == 2
        assert got["rows"] == slice(4 * d, 4 * d + 4)
    for kind in jax_samplers:
        assert all(np.array_equal(a, b) for a, b in zip(
            _result(group, "feed", 0)[kind], _result(group, "feed", 1)[kind]))


def _jax_shard_shapes(jstate, mesh_):
    """Parameter path -> the shape of device 0's shard under JAX's
    ``place_state`` on ``mesh_``."""
    placed = jax_sharding.place_state(jstate, mesh_)
    flat, _ = jax.tree_util.tree_flatten_with_path(placed.params)
    return {tuple(p.key for p in path): leaf.addressable_shards[0].data.shape
            for path, leaf in flat}


@pytest.mark.parametrize("case", ["cremad", "mimic"])
def test_ranks_hold_their_blocks(group, case):
    """What each rank holds of each leaf JAX's TP rule shards: half of it
    on the output dim (the model axis's size is 2), as JAX's shard on a
    device, and its momentum alike; a column-parallel Dense computes on
    it, another leaf is gathered whole (for a step or, as here, a
    checkpoint); every leaf JAX's rule replicates is whole."""
    init = {"cremad": lambda: P._jax_init("ogm_ge")[1],
            "mimic": lambda: _mimic_inputs()[1]}[case]()
    jax_shapes = _jax_shard_shapes(init, _jax_mesh())
    held = _result(group, case)["held"]
    with pytest.MonkeyPatch.context() as mp:
        if case == "cremad":
            P._narrow(mp, "cremad", {})
        args = SimpleNamespace(**group["inputs"][case]["args"])
        mod = P.cremad if case == "cremad" else mimic
        model = mod.get_model_spec(args, n_train=40)[0].module
    for key, (coll, path, kind) in jax_key_map(model).items():
        if coll != "params":
            continue
        paths = path if isinstance(path[0], tuple) else (path,)
        sharded = [jax_shapes[p] != get_leaf(init.params, p).shape
                   for p in paths]
        assert (key in held) == any(sharded), key
        if key in held:
            param, shard, full, momentum = held[key]
            assert all(sharded), key
            assert param in (shard, full) and shard[0] * 2 == full[0], key
            assert shard[1:] == full[1:] and momentum == shard, key
    assert held, "no leaf sharded"


def _port_state(case, inp, tree):
    with pytest.MonkeyPatch.context() as mp:
        if case == "cremad":
            P._narrow(mp, "cremad", {})
        args = SimpleNamespace(**inp["args"])
        mod = P.cremad if case == "cremad" else mimic
        spec, _ = mod.get_model_spec(args, n_train=inp["n_train"])
        state = create_train_state(spec, args, seed=0, steps_per_epoch=100,
                                   device="cpu")
    load_jax_variables(state.model, inp["params"], inp["stats"])
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    if tree is not None:
        state.model.load_state_dict({k: torch.from_numpy(v)
                                     for k, v in tree["model"].items()})
        state.optimizer.load_state_dict(tree["optimizer"])
        state.ema = torch.from_numpy(tree["ema"])
        state.step = tree["step"]
    return spec, state, init


@pytest.mark.parametrize("case", ["cremad", "mimic"])
def test_tensor_parallel_steps_match_jax(group, case):
    """The train steps on four ranks under ``{data: 2, model: 2}`` against
    JAX's on its mesh of the same shape: the metrics, every parameter's
    update, the momentum, the BN buffers and the EMA; all four ranks hold
    the same."""
    ranks = [_result(group, case, r) for r in range(WORLD)]
    jrun = group["jax"][case]
    for other in ranks[1:]:
        assert other["metrics"] == ranks[0]["metrics"]
        for key, value in ranks[0]["model"].items():
            assert np.array_equal(value, other["model"][key]), key
    for step, (m, jm) in enumerate(zip(ranks[0]["metrics"],
                                       jrun["jmetrics"])):
        assert set(m) == set(jm)
        for k in m:
            if k in H.CONTINUOUS:
                np.testing.assert_allclose(m[k], jm[k], rtol=H.LOSS_RTOL,
                                           err_msg=f"step {step} {k}")
            else:
                assert m[k] == jm[k], (step, k)
    assert len(ranks[0]["metrics"]) == len(jrun["jmetrics"])
    if case == "cremad":
        assert jrun["noise_calls"] > 0
    spec, state, init = _port_state(case, group["inputs"][case],
                                    ranks[0])
    H.check_state(dict(state=state, jstate=jrun["jstate"], init=init,
                       spec=spec, grads=[]))


@pytest.mark.parametrize("case", ["cremad", "mimic"])
def test_tensor_parallel_checkpoint_loads_in_one_process(group, case):
    """The checkpoint rank 0 wrote under ``{data: 2, model: 2}`` holds the
    full tree: a one-process state restores it with every parameter,
    buffer and momentum equal to the ranks' gathered tree, bit for bit."""
    tree = _result(group, case)
    _, state, _ = _port_state(case, group["inputs"][case], None)
    restored = BestCheckpointer(group["work"] / f"ckpt_{case}").restore_last(
        state)
    assert restored.step == tree["step"]
    for key, value in restored.model.state_dict().items():
        assert np.array_equal(value.numpy(), tree["model"][key]), key
    params = [p for g in restored.optimizer.param_groups for p in g["params"]]
    for i, entry in tree["optimizer"]["state"].items():
        assert torch.equal(restored.optimizer.state[params[i]][
            "momentum_buffer"], entry["momentum_buffer"]), i
