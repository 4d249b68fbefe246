"""The port's stage axis (GPipe through SigLIP's ``PipelinedEncoderStack``)
and sequence sharding under tensor parallelism, over four ranks, against
the JAX package on the same mesh, on the CPU.

One four-process gloo group serves the file: the module fixture starts
four ``torch_port_model_axis_worker.py`` processes (set ``pp``) over a
``file://`` store, computes JAX's inits of Food101 jlogits on the
benchmark harness's narrowed SigLIP (width 64, two layers, two heads)
meanwhile, writes them to ``tmp_path``, runs JAX on its four-device mesh
of each case's shape and collects what each rank wrote.  The cases:

  * TP x SP, ``{data: 2, model: 2}`` with ``sequence_sharding``: two
    train steps (the second with a padded tail) with the heads' dropout
    masks injected;
  * GPipe, ``{data: 2, stage: 2}``, two stages of one block and 4
    microbatches: the eval forward's logits and every leaf's gradient of
    the jlogits loss on the global batch, then two train steps as above;
  * the CLI on the harness's Food101 twin under each layout, one epoch.

Tolerances.  The ranks against each other and the checkpoints' round
trips are exact.  The train steps are held as ``test_torch_port_food101
.py`` holds one process against JAX (``torch_port_contract_harness.py``:
losses 1e-5 relative, parameter updates and momentum 3e-4 of each
tensor's largest entry, attention's key bias, whose gradient is zero in
exact arithmetic, to rounding); the logits within 1e-5 of their largest
entry, and each leaf's gradient within 3e-4 of its largest entry (a
gradient below 1e-6 everywhere on both sides, the key bias's, held
there), the same fp32 terms summed in another order.  The CLI under
each layout against one process: the test summary's losses and
accuracies within 1e-4 relative (the data-parallel CLI test's limit).
"""

import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.benchmarks import food101 as jax_food101
from multimodal_clinical_tpu.engine import contracts as jax_contracts
from multimodal_clinical_tpu.engine.state import (
    create_train_state as jax_create_train_state,
)
from multimodal_clinical_tpu.engine.steps import (
    make_train_step as jax_make_train_step,
)
from multimodal_clinical_tpu.models import zoo as jax_zoo
from multimodal_clinical_tpu.parallel import mesh as jax_mesh
from multimodal_clinical_tpu.parallel import sharding as jax_sharding

import multimodal_clinical_tpu_torch.__main__ as port_main
from multimodal_clinical_tpu_torch.benchmarks import food101
from multimodal_clinical_tpu_torch.engine.checkpoint import BestCheckpointer
from multimodal_clinical_tpu_torch.engine.state import create_train_state
from multimodal_clinical_tpu_torch.models.jax_weights import (
    get_leaf, jax_key_map, load_jax_variables, to_torch_layout,
)

import torch_port_benchmark_harness as BH
import torch_port_contract_harness as H

torch.set_num_threads(2)

TESTS = Path(__file__).resolve().parent
WORLD = 4
GLOBAL_B, TAIL = 8, 6
GRAD_TOL = 3e-4
LOGITS_TOL = 1e-5
CLI_RTOL = 1e-4
ROUNDING = (".k_proj.bias",)
SHAPES = {"sp": {"data": 2, "model": 2},
          "pp": {"data": 2, "model": 1, "stage": 2}}
SETTINGS = {"sp": {"sequence_sharding": True},
            "pp": {"pipeline_stages": 2, "pipeline_microbatches": 4}}


def _jax_mesh(case):
    return jax_mesh.make_mesh(SHAPES[case], devices=jax.devices()[:WORLD])


def _batches():
    """Two global batches of 8 rows, the second with 6 real ones (each
    data coordinate's 4 rows: 4 and 2 real)."""
    rng = np.random.default_rng(4)
    out = []
    for step, real in enumerate((GLOBAL_B, TAIL)):
        rows = np.arange(GLOBAL_B).clip(max=real - 1)
        out.append({
            "x1": rng.integers(1, 1000, (GLOBAL_B, 16)).astype(np.int32)[rows],
            "x2": rng.normal(size=(GLOBAL_B, 32, 32, 3)).astype(
                np.float32)[rows],
            "label": rng.integers(0, 101, GLOBAL_B)[rows],
            "idx": np.arange(GLOBAL_B)[rows] + step * GLOBAL_B,
            "valid": (np.arange(GLOBAL_B) < real).astype(np.float32)})
    return out


def _args(case):
    return BH._args("food101", "jlogits", batch_size=GLOBAL_B,
                    **SETTINGS[case])


def _init(case):
    """JAX's spec and state of the narrowed Food101 net on the case's
    mesh, and the worker's inputs."""
    args = _args(case)
    mesh_ = _jax_mesh(case)
    batches = _batches()
    with pytest.MonkeyPatch.context() as mp:
        BH.narrow("food101", mp)
        jspec, _ = jax_food101.get_model_spec(args, n_train=16, mesh=mesh_)
        mp.setattr(jax_zoo.Food101FusionNet, "init", H._cached_init(
            f"food101 {case}", jax_zoo.Food101FusionNet.init, H.FAST_INIT))
        jstate = jax_create_train_state(
            jspec, args, jax.random.PRNGKey(0),
            [jnp.asarray(batches[0][k][:2]) for k in ("x1", "x2")],
            steps_per_epoch=100)
        spec, _ = food101.get_model_spec(args, n_train=16)
    return jspec, jstate, dict(
        args=vars(args), n_train=16, batches=batches, batch=batches[0],
        n_dropouts=BH.count_dropouts(spec.module),
        params=jax.tree_util.tree_map(np.asarray, jstate.params),
        stats={})


def _run_jax_steps(case, jspec, jstate, inp):
    mesh_ = _jax_mesh(case)
    with pytest.MonkeyPatch.context() as mp:
        BH.narrow("food101", mp)
        BH.patch_dropout(mp, inp["n_dropouts"])
        jstate = jax_sharding.place_state(jstate, mesh_)
        jtrain = jax_make_train_step(jspec)
        jmetrics = []
        with mesh_:
            for batch in inp["batches"]:
                jstate, jm = jtrain(jstate, jax_mesh.put_batch(
                    H._to_jax(batch), mesh_))
                jmetrics.append({k: float(v) for k, v in jm.items()})
    return dict(jstate=jstate, jmetrics=jmetrics)


def _run_jax_grads(jspec, jstate, inp):
    """The pipelined net's eval forward and jlogits loss gradient on the
    ``{data: 2, stage: 2}`` mesh."""
    mesh_ = _jax_mesh("pp")
    batch = H._to_jax(inp["batch"])

    def loss(params):
        out = jspec.module.apply({"params": params}, batch["x1"],
                                 batch["x2"], train=False)
        fused = jax_contracts.fuse_logits(out["logits"])
        return jax_contracts.cross_entropy(fused, batch["label"],
                                           batch["valid"]), out["logits"]

    with pytest.MonkeyPatch.context() as mp:
        BH.narrow("food101", mp)
        placed = jax_sharding.place_state(jstate, mesh_)
        with mesh_:
            (value, logits), grads = jax.jit(jax.value_and_grad(
                loss, has_aux=True))(placed.params)
    return dict(loss=float(value), logits=[np.asarray(l) for l in logits],
                grads=jax.tree_util.tree_map(np.asarray, grads))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The four ranks' results, JAX's runs on the same meshes and a
    one-process CLI run."""
    work = tmp_path_factory.mktemp("pipeline")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(TESTS.parent), str(TESTS), os.environ.get("PYTHONPATH", "")])}
    logs = [open(work / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(TESTS / "torch_port_model_axis_worker.py"),
         str(r), str(work), "pp"], stdout=logs[r], stderr=subprocess.STDOUT,
        env=env, cwd=TESTS.parent) for r in range(WORLD)]
    try:
        inits = {case: _init(case) for case in SHAPES}
        inputs = {"food": inits["sp"][2], "food_pp": inits["pp"][2]}
        with open(work / "inputs.pkl.part", "wb") as f:
            pickle.dump(inputs, f)
        os.replace(work / "inputs.pkl.part", work / "inputs.pkl")
        # the gradients first: a JAX train step donates its state
        jax_runs = {"pp_grads": _run_jax_grads(*inits["pp"])}
        jax_runs.update({case: _run_jax_steps(case, *inits[case])
                         for case in SHAPES})
        with pytest.MonkeyPatch.context() as mp:
            BH.narrow("food101", mp)
            one = port_main.run_training(
                ["--dir", "food101", "--set", "num_epochs=1",
                 "--set", "model_type=jlogits",
                 "--set", "compute_dtype=float32",
                 "--set", f"ckpt_dir={work / 'cli_one'}",
                 "--set", f"data_path={work / 'none'}"], device="cpu")
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
                cli_one=one)


def _result(group, case, rank=0):
    out = group["ranks"][rank][case]
    assert not (isinstance(out, dict) and "error" in out), out.get("error")
    return out


def _port_state(case, inp, tree):
    """A one-process state of the case's net (the stacked layout for the
    pipeline), at the JAX init's weights, then at ``tree``'s."""
    from multimodal_clinical_tpu_torch.models import siglip

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(siglip, "SigLIPModel", functools.partial(
            siglip.SigLIPModel, **BH.SIGLIP_TINY))
        args = SimpleNamespace(**inp["args"])
        spec, _ = food101.get_model_spec(args, n_train=inp["n_train"])
        state = create_train_state(spec, args, seed=0, steps_per_epoch=100,
                                   device="cpu")
    load_jax_variables(state.model, inp["params"], {})
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    if tree is not None:
        state.model.load_state_dict({k: torch.from_numpy(v)
                                     for k, v in tree["model"].items()})
        state.optimizer.load_state_dict(tree["optimizer"])
        state.ema = torch.from_numpy(tree["ema"])
        state.step = tree["step"]
    return spec, state, init


def _inputs(group, case):
    return group["inputs"]["food" if case == "sp" else "food_pp"]


@pytest.mark.parametrize("case", ["sp", "pp"])
def test_steps_match_jax(group, case):
    """Two train steps on four ranks against JAX's on its mesh of the same
    shape: the metrics, every parameter's update, the momentum and the
    EMA; all four ranks hold the same.  Under TP x SP each tower's blocks
    gathered their keys and values over the model axis."""
    ranks = [_result(group, case, r) for r in range(WORLD)]
    jrun = group["jax"][case]
    for other in ranks[1:]:
        assert other["metrics"] == ranks[0]["metrics"]
        for key, value in ranks[0]["model"].items():
            assert np.array_equal(value, other["model"][key]), key
    assert len(ranks[0]["metrics"]) == len(jrun["jmetrics"]) == 2
    for step, (m, jm) in enumerate(zip(ranks[0]["metrics"],
                                       jrun["jmetrics"])):
        assert set(m) == set(jm)
        for k in m:
            if k in H.CONTINUOUS:
                np.testing.assert_allclose(m[k], jm[k], rtol=H.LOSS_RTOL,
                                           err_msg=f"step {step} {k}")
            else:
                assert m[k] == jm[k], (step, k)
    # two towers x two blocks, a forward each step (the backward's
    # gradients go through autograd)
    assert ranks[0]["sequence_gathers"] == (8 if case == "sp" else 0)
    spec, state, init = _port_state(case, _inputs(group, case), ranks[0])
    H.check_state(dict(state=state, jstate=jrun["jstate"], init=init,
                       spec=spec, grads=ranks[0]["grads"]),
                  rounding_grads=ROUNDING)


def test_pipeline_forward_and_every_gradient_match_jax(group):
    """GPipe over ``{data: 2, stage: 2}`` with 4 microbatches: each data
    coordinate's logits of the eval forward, the jlogits loss on the
    global batch and every leaf's gradient (a stage rank's stage gathered
    with the other's) against JAX's pipeline on the same mesh; the leaves
    outside the pipeline (the embeddings before it, the heads after it)
    end the backward with the same gradient on every rank."""
    jrun = group["jax"]["pp_grads"]
    ranks = [_result(group, "pp_grads", r) for r in range(WORLD)]
    for r, got in enumerate(ranks):
        rows = slice(4 * (r // 2), 4 * (r // 2) + 4)
        for mine, want in zip(got["logits"], jrun["logits"]):
            H._scaled_close(mine, want[rows], LOGITS_TOL, f"logits {r}")
        np.testing.assert_allclose(got["loss"], jrun["loss"],
                                   rtol=H.LOSS_RTOL)
        for key, value in got["grads"].items():
            assert np.array_equal(value, ranks[0]["grads"][key]), (r, key)
    _, state, _ = _port_state("pp", _inputs(group, "pp"), None)
    grads = ranks[0]["grads"]
    keys = jax_key_map(state.model)
    assert set(grads) == {k for k, (c, _, _) in keys.items()
                          if c == "params"}
    stacked = 0
    for key, (coll, path, kind) in keys.items():
        if coll != "params":
            continue
        want = to_torch_layout(kind, get_leaf(jrun["grads"], path))
        got = grads[key]
        assert got.shape == want.shape, key
        stacked += kind.startswith("stages:")
        if np.abs(want).max() <= H.ROUNDING_GRAD:
            assert np.abs(got).max() <= H.ROUNDING_GRAD, key
            continue
        H._scaled_close(got, want, GRAD_TOL, key)
    assert stacked, "no pipelined leaf"
    held = ranks[0]["held"]
    assert held and all(k.split(".")[2] == "pipeline" for k in held)
    for key, (param, shard, full, _) in held.items():
        assert param == shard == (1,) + full[1:] and full[0] == 2, key


@pytest.mark.parametrize("case", ["sp", "pp"])
def test_checkpoint_loads_in_one_process(group, case):
    """The checkpoint rank 0 wrote under the case's mesh holds the full
    tree (the pipelined stack whole, in its one-device layout): a
    one-process state of the same net restores it bit for bit."""
    tree = _result(group, case)
    _, state, _ = _port_state(case, _inputs(group, case), None)
    restored = BestCheckpointer(group["work"] / f"ckpt_{case}").restore_last(
        state)
    assert restored.step == tree["step"] == 2
    for key, value in restored.model.state_dict().items():
        assert np.array_equal(value.numpy(), tree["model"][key]), key
    params = [p for g in restored.optimizer.param_groups for p in g["params"]]
    for i, entry in tree["optimizer"]["state"].items():
        assert torch.equal(restored.optimizer.state[params[i]][
            "momentum_buffer"], entry["momentum_buffer"]), i


@pytest.mark.parametrize("case", ["sp", "pp"])
def test_cli_on_four_ranks_matches_one_process(group, case):
    """``run_training`` on the four ranks with ``mesh_shape: {data: 2,
    model: 2}`` and ``sequence_sharding``, or ``{data: 2, stage: 2}`` and
    ``pipeline_stages: 2``, one epoch of the narrowed Food101 twin: the
    ranks' test summaries are equal, and within CLI_RTOL of one process
    without a mesh (the pipelined net draws the plain one's weights)."""
    got = [_result(group, f"cli_{case}", r)["summary"] for r in range(WORLD)]
    assert all(g == got[0] for g in got[1:])
    one = group["cli_one"]
    assert set(got[0]) == set(one)
    for key, value in one.items():
        np.testing.assert_allclose(got[0][key], value, rtol=CLI_RTOL,
                                   err_msg=key)
