"""The port's data axis (``multimodal_clinical_tpu_torch/parallel/``)
against the JAX package's data mesh, on the CPU.

One two-process gloo group serves the file: the module fixture writes the
JAX inits' weights, the global batches and the injected randomness to a
``tmp_path`` directory, starts two ``torch_port_parallel_worker.py``
processes there (a ``file://`` store, no TCP port), runs the JAX side
while they work, and collects what each rank wrote.  The JAX side runs in
this process on the conftest's eight CPU devices, its default mesh the
data axis over all eight, so global batches are multiples of 8.

Tolerances.  The rule checks, the ranks against each other, FSDP against
data parallelism and the checkpoint's round trip are exact.  Global
BatchNorm on two ranks against one process and against flax sums the
same fp32 terms in another order: outputs and input gradients within
1e-5 of each tensor's largest entry, the parameters' gradients and the
running statistics within 1e-5 relative and absolute.  The train steps
are held as ``torch_port_contract_harness.py`` holds one process against
JAX (losses 1e-5 relative, parameter updates and momentum 3e-4 of each
tensor's largest entry, BN buffers 1e-4 relative and 1e-5 absolute, the
EMA 1e-5, the QMF tables 1e-5 relative and 1e-6 absolute, eval logits
1e-5): under data parallelism the port sums each rank's gradient, where
XLA sums the batch's in one reduction, which is one more reordering of
the same fp32 terms.  Their data (numpy seed DATA_SEED) cross no ReLU or
max-pool threshold in the two steps, which those limits would show.  The
CLI on two ranks against one: losses and accuracies of the test summary
within 1e-4 relative (fp32; global BN from sums against cuDNN-free
``F.batch_norm`` statistics, rounded in another order).
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

from multimodal_clinical_tpu.benchmarks import cremad as jax_cremad
from multimodal_clinical_tpu.benchmarks import vggsound as jax_vggsound
from multimodal_clinical_tpu.data import sampler as jax_sampler
from multimodal_clinical_tpu.engine.state import (
    create_train_state as jax_create_train_state,
)
from multimodal_clinical_tpu.engine.steps import (
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step,
)
from multimodal_clinical_tpu.models import resnet as jax_resnet
from multimodal_clinical_tpu.models import zoo as jax_zoo
from multimodal_clinical_tpu.ops import fused_bn as jax_fused_bn
from multimodal_clinical_tpu.parallel import mesh as jax_mesh
from multimodal_clinical_tpu.parallel import sharding as jax_sharding

import multimodal_clinical_tpu_torch.__main__ as port_main
import multimodal_clinical_tpu_torch.data.synthetic as port_syn
from multimodal_clinical_tpu_torch.benchmarks import cremad, vggsound
from multimodal_clinical_tpu_torch.engine import run
from multimodal_clinical_tpu_torch.engine.checkpoint import BestCheckpointer
from multimodal_clinical_tpu_torch.engine.state import create_train_state
from multimodal_clinical_tpu_torch.models import zoo as port_zoo
from multimodal_clinical_tpu_torch.models.jax_weights import (
    get_leaf, jax_key_map, to_torch_layout,
)
from multimodal_clinical_tpu_torch.models.resnet import ResNetEncoder
from multimodal_clinical_tpu_torch.parallel import mesh, sharding

import torch_port_contract_harness as H

torch.set_num_threads(2)

TESTS = Path(__file__).resolve().parent
WIDTH, STAGES = H.WIDTH, H.STAGES
GLOBAL_B, RANK_B, N_TRAIN, DATA_SEED = 16, 8, 40, 3
# the padded last batch as each rank pads its own shard (the loader
# repeats the last real row): 7 real rows on rank 0 and 6 on rank 1
TAIL_REAL = (7, 6)
SWITCHED = dict(bn_fused=True, pool_kernel="pallas")
STEP_CASES = {
    "jprobas": ("vggsound", "jprobas", {}),
    "jprobas_switched": ("vggsound", "jprobas", SWITCHED),
    "ogm_ge": ("cremad", "ogm_ge", {}),
    "qmf": ("cremad", "qmf", {}),
}
# the eval step is held against JAX's for these (the others' eval is
# theirs with another loss, held in test_torch_port_contracts.py)
EVAL_CASES = ("jprobas", "qmf")
PORT_MODULES = {"vggsound": vggsound, "cremad": cremad}
JAX_MODULES = {"vggsound": jax_vggsound, "cremad": jax_cremad}
# FSDP at the narrow width: leaves of at least this many elements shard
FSDP_MIN = 1024
BN_TOL = 1e-5
CLI_RTOL = 1e-4
CLI_SHAPES = [(17, 20, 1), (2, 16, 16, 3)]
CLI_ARGV = ["--dir", "vggsound", "--set", "num_epochs=1",
            "--set", "batch_size=16", "--set", "num_classes=5",
            "--set", "compute_dtype=float32", "--set", "log_every_n_steps=2"]


def _global_batches(bench):
    """Two global batches of GLOBAL_B rows: a full one, then one with each
    rank's shard padded as the loader pads it."""
    _, _, classes, frames, samples = H.BENCHMARKS[bench]
    rng = np.random.default_rng(DATA_SEED)
    ids = rng.permutation(N_TRAIN)
    out = []
    for step in range(2):
        real = (RANK_B, RANK_B) if step == 0 else TAIL_REAL
        rows = np.concatenate([r * RANK_B + np.arange(RANK_B).clip(
            max=n - 1) for r, n in enumerate(real)])
        wave = rng.normal(scale=0.1, size=(GLOBAL_B, samples)).astype(
            np.float32)
        x2 = rng.integers(0, 256, size=(GLOBAL_B, frames, H.FRAME_SIZE,
                                        H.FRAME_SIZE, 3), dtype=np.uint8)
        label = rng.integers(0, classes, size=GLOBAL_B)
        idx = ids[step * GLOBAL_B:(step + 1) * GLOBAL_B]
        valid = np.concatenate([(np.arange(RANK_B) < n).astype(np.float32)
                                for n in real])
        out.append({"x1_waveform": wave[rows], "x2": x2[rows],
                    "label": label[rows], "idx": idx[rows], "valid": valid})
    return out


def _masks(step, f, t):
    """Narrow SpecAugment bands for GLOBAL_B rows (as the harness's)."""
    rng = np.random.default_rng(100 + step)
    masks = []
    for dim in (f, t):
        mask = np.ones((GLOBAL_B, dim), np.float32)
        for row in range(GLOBAL_B):
            for _ in range(2):
                width = rng.integers(1, 4)
                start = rng.integers(0, dim - width)
                mask[row, start:start + width] = 0.0
        masks.append(mask)
    return masks


def _narrow(mp, bench, switches):
    port_mod, jax_mod = PORT_MODULES[bench], JAX_MODULES[bench]
    mp.setattr(jax_zoo, "ResNetEncoder", functools.partial(
        jax_resnet.ResNetEncoder, width=WIDTH, stage_sizes=STAGES,
        **switches))
    mp.setattr(port_zoo, "ResNetEncoder", functools.partial(
        ResNetEncoder, stage_sizes=STAGES, **switches))
    mp.setattr(port_mod, "CremadFusionNet", functools.partial(
        port_zoo.CremadFusionNet, width=WIDTH))
    return port_mod, jax_mod


def _case_args(bench, model_type):
    classes = H.BENCHMARKS[bench][2]
    return dict(num_classes=classes, batch_size=GLOBAL_B,
                learning_rate=1e-2, num_epochs=60, use_scheduler=False,
                seed=0, model_type=model_type)


def _jax_init(name):
    """The JAX spec and state of a step case (its narrowed flax init)."""
    bench, model_type, switches = STEP_CASES[name]
    frames = H.BENCHMARKS[bench][3]
    args = SimpleNamespace(**_case_args(bench, model_type))
    with pytest.MonkeyPatch.context() as mp:
        _, jax_mod = _narrow(mp, bench, switches)
        jspec, _ = jax_mod.get_model_spec(args, n_train=N_TRAIN)
        # one init a benchmark, compiled without XLA's backend
        # optimisations (the harness's FAST_INIT): the switched towers
        # have the default ones' tree
        mp.setattr(jax_zoo.CremadFusionNet, "init", H._cached_init(
            f"parallel_{bench}", jax_zoo.CremadFusionNet.init, H.FAST_INIT))
        sample = [jnp.zeros((2, 33, 40, 1)),
                  jnp.zeros((2, frames, H.FRAME_SIZE, H.FRAME_SIZE, 3))]
        jstate = jax_create_train_state(jspec, args, jax.random.PRNGKey(0),
                                        sample, steps_per_epoch=100)
    return jspec, jstate


def _step_inputs(name, jstate):
    bench, model_type, switches = STEP_CASES[name]
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    batches = _global_batches(bench)
    f, t = H._port_front_end(
        "log_spectrogram" if bench == "vggsound" else "cremad_spectrogram",
        batches[0]["x1_waveform"][:1]).shape[1:]
    noise = H._noise(params, np.random.default_rng(7))
    with pytest.MonkeyPatch.context() as mp:
        _narrow(mp, bench, switches)
        model = port_zoo.CremadFusionNet(H.BENCHMARKS[bench][2], width=WIDTH)
    by_path = {path: key for key, (coll, path, _) in
               jax_key_map(model).items() if coll == "params"}
    return dict(bench=bench, switches=switches, stages=STAGES, width=WIDTH,
                args=_case_args(bench, model_type), n_train=N_TRAIN,
                params=params,
                stats=jax.tree_util.tree_map(np.asarray, jstate.batch_stats),
                batches=batches, masks=[_masks(s, f, t) for s in range(2)],
                noise={by_path[p]: np.ascontiguousarray(
                    to_torch_layout("conv", a)) for p, a in noise},
                jax_noise=noise)


def _patch_front_ends(mp, batches):
    """The JAX front ends replaced by the port's spectrograms of
    ``batches``, computed here and picked by the waveform the step is
    given (the harness's host callback into the port's, which XLA's
    partitioner runs on one device, stalled the data mesh's other devices
    at their next all-reduce on this CPU)."""
    for name in ("log_spectrogram", "cremad_spectrogram"):
        def front_end(wave, _name=name, **kwargs):
            specs = [(jnp.asarray(b["x1_waveform"][:, :8]), jnp.asarray(
                H._port_front_end(_name, b["x1_waveform"], **kwargs)))
                for b in batches]
            out = jnp.zeros_like(specs[0][1])  # no batch's: all zero
            for head, spec in specs:
                out = jnp.where(jnp.all(wave[:, :8] == head), spec, out)
            return out
        mp.setattr(H.jax_spectrogram, name, front_end)


def _run_jax(name, jspec, jstate, inp):
    """Two train steps and one eval step of JAX's jitted step over its
    data mesh (eight CPU devices), the noise and masks injected."""
    bench, _, switches = STEP_CASES[name]
    mesh_ = jax_mesh.make_mesh()
    assert mesh_.shape[jax_mesh.DATA_AXIS] == 8
    with pytest.MonkeyPatch.context() as mp:
        port_mod, _ = _narrow(mp, bench, switches)
        noise = inp["jax_noise"]
        calls = []

        def normal(key, shape, dtype=jnp.float32):
            path, arr = noise[len(calls) % len(noise)]
            calls.append(path)
            assert tuple(shape) == arr.shape, path
            return jnp.asarray(arr, dtype)

        H.patch_ogm_normal(mp, normal)
        _patch_front_ends(mp, inp["batches"])
        drawn = H.patch_mask_draws(mp, port_mod, jstate, inp["masks"])
        jstate = jax_sharding.place_state(jstate, mesh_)
        jtrain, jeval = jax_make_train_step(jspec), jax_make_eval_step(jspec)
        jmetrics = []
        for batch in inp["batches"]:
            jstate, jm = jtrain(jstate, jax_mesh.put_batch(
                H._to_jax(batch), mesh_))
            jmetrics.append({k: float(v) for k, v in jm.items()})
        jout = None
        if name in EVAL_CASES:
            jout = {k: np.asarray(v) for k, v in jeval(
                jstate, jax_mesh.put_batch(H._to_jax(inp["batches"][-1]),
                                           mesh_)).items()}
    return dict(jstate=jstate, jmetrics=jmetrics, jout=jout, drawn=drawn,
                noise_calls=len(calls))


def _bn_inputs():
    rng = np.random.default_rng(11)
    return dict(x=rng.normal(size=(8, 4, 3, 5)).astype(np.float32) + 0.5,
                w=rng.normal(size=(8, 4, 3, 5)).astype(np.float32),
                scale=rng.normal(1.0, 0.1, size=4).astype(np.float32),
                bias=rng.normal(size=4).astype(np.float32))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Both ranks' results and the JAX runs of the step cases."""
    work = tmp_path_factory.mktemp("parallel")
    inputs = dict(bn=_bn_inputs(),
                  cli=dict(shapes=CLI_SHAPES, width=4, argv=CLI_ARGV))
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(TESTS.parent), str(TESTS), os.environ.get("PYTHONPATH", "")])}
    logs = [open(work / f"rank{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(TESTS / "torch_port_parallel_worker.py"),
         str(r), str(work)], stdout=logs[r], stderr=subprocess.STDOUT,
        env=env, cwd=TESTS.parent) for r in range(2)]
    try:
        # the workers run their other cases while the JAX inits compile
        inits = {name: _jax_init(name) for name in STEP_CASES}
        steps = {name: _step_inputs(name, jstate)
                 for name, (_, jstate) in inits.items()}
        inputs.update(
            steps={n: {k: v for k, v in s.items() if k != "jax_noise"}
                   for n, s in steps.items()},
            fsdp_min_size=FSDP_MIN)
        with open(work / "steps.pkl.part", "wb") as f:
            pickle.dump({k: inputs[k] for k in ("steps", "fsdp_min_size")},
                        f)
        os.replace(work / "steps.pkl.part", work / "steps.pkl")
        jax_runs = {name: _run_jax(name, *inits[name], steps[name])
                    for name in STEP_CASES}
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
    assert codes == [0, 0], (codes, [(work / f"rank{r}.log").read_text()[
        -4000:] for r in range(2)])
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return dict(work=work, ranks=ranks, inputs=inputs, steps=steps,
                inits=inits, jax=jax_runs)


def _result(group, case, rank=0):
    out = group["ranks"][rank][case]
    assert not (isinstance(out, dict) and "error" in out), out.get("error")
    return out


# -- rules -----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tree(net):
    """(the JAX parameter tree's shapes, the port's net on the meta
    device) of the VGGSound, Food101-SigLIP or MIMIC net at full width."""
    jmod, sample, make = {
        "vggsound": (jax_zoo.CremadFusionNet(309),
                     (jnp.zeros((2, 33, 40, 1)),
                      jnp.zeros((2, 1, 32, 32, 3))),
                     lambda: port_zoo.CremadFusionNet(309)),
        "food101": (jax_zoo.Food101FusionNet(101),
                    (jnp.zeros((2, 64), jnp.int32),
                     jnp.zeros((2, 224, 224, 3))),
                    lambda: port_zoo.Food101FusionNet(101)),
        "mimic": (jax_zoo.MimicFusionNet(2),
                  (jnp.zeros((2, 5)), jnp.zeros((2, 24, 12))),
                  lambda: port_zoo.MimicFusionNet(2)),
    }[net]
    shapes = jax.eval_shape(functools.partial(jmod.init, train=False),
                            jax.random.PRNGKey(0), *sample)["params"]
    with torch.device("meta"):
        return shapes, make()


# the kinds whose torch leaf is a permutation of the flax one
PERMUTED = ("conv", "dense", "vector", "table")


@pytest.mark.parametrize("net", ["vggsound", "food101", "mimic"])
@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_rule_matches_jax(net, world):
    """Every parameter leaf: sharded by the port exactly where JAX's
    ``_fsdp_dim`` shards it, on the same elements (the flax leaf's
    entries, numbered, split JAX's way and the port's way through the
    layout of ``models/jax_weights.py``), the data axis's name in the
    port's ``param_spec`` at that dim; a leaf whose torch layout merges
    flax axes (attention heads, packed gates) shards where JAX's does,
    1/D of it."""
    shapes, model = _tree(net)
    named = dict(model.named_parameters())
    counted = {"sharded": 0, "replicated": 0}
    for key, (coll, path, kind) in jax_key_map(model).items():
        if coll != "params":
            continue
        leaf = named[key]
        t = sharding.fsdp_dim(tuple(leaf.shape), world, kind)
        spec = sharding.param_spec(leaf, world, kind)
        paths = path if isinstance(path[0], tuple) else (path,)
        jdims = [jax_sharding._fsdp_dim(get_leaf(shapes, p), world)
                 for p in paths]
        assert (t >= 0) == all(d >= 0 for d in jdims), (key, t, jdims)
        counted["sharded" if t >= 0 else "replicated"] += 1
        if t < 0:
            assert spec == ()
            continue
        assert spec[t] == "data" and sum(s is not None for s in spec) == 1
        assert leaf.shape[t] % world == 0
        if kind not in PERMUTED:
            continue
        flax = get_leaf(shapes, path)
        numbered = np.arange(int(np.prod(flax.shape))).reshape(flax.shape)
        mine = np.split(to_torch_layout(kind, numbered, np.int64), world,
                        axis=t)
        theirs = np.split(numbered, world, axis=jdims[0])
        for a, b in zip(mine, theirs):
            assert np.array_equal(np.sort(a, axis=None),
                                  np.sort(b, axis=None)), key
    # MIMIC's leaves are all under _FSDP_MIN_SIZE: replicated on both sides
    assert bool(counted["sharded"]) == (net != "mimic"), counted
    assert counted["replicated"], counted


def test_fsdp_dim_matches_jax_on_shapes():
    """The rule itself on the shapes of ``tests/test_sharding.py`` and on
    the edge cases: small leaves, odd dims, the last dim first."""
    for shape in [(16, 8), (3, 3, 4, 8), (16, 7), (256, 256), (3, 3, 64, 128),
                  (7, 9, 1031), (65536,), (65535,), (1, 196, 768),
                  (768, 12, 64), (12, 64, 768)]:
        for world in (1, 2, 3, 8):
            leaf = np.zeros(shape, np.float32)
            assert sharding._fsdp_dim(shape, world) == \
                jax_sharding._fsdp_dim(leaf, world), (shape, world)
    assert sharding._FSDP_MIN_SIZE == jax_sharding._FSDP_MIN_SIZE


def test_mesh_shapes_and_errors_match_jax(group):
    """``make_mesh`` over the two ranks, beside JAX's over two devices:
    the same axis sizes, the model and stage meshes included, and the
    same error for sizes that do not multiply to the device count."""
    got = _result(group, "mesh")
    devices = jax.devices()[:2]
    want = jax_mesh.make_mesh(devices=devices)
    assert got["default"] == {"data": want.shape["data"],
                              "model": want.shape["model"]}
    assert got["data2"] == {"data": 2, "model": 1}
    with pytest.raises(ValueError) as exc:
        jax_mesh.make_mesh({"data": 4}, devices=devices)
    assert got["data4"] == ("ValueError", str(exc.value))
    for name, shape in (("model2", {"model": 2}),
                        ("stage2", {"data": 1, "stage": 2})):
        assert got[name] == dict(jax_mesh.make_mesh(
            shape, devices=devices).shape), name
    assert group["ranks"][0]["backend"] == "gloo"
    assert [r["rank"] for r in group["ranks"]] == [0, 1]
    assert all(r["world"] == 2 and r["device"] == "cpu"
               for r in group["ranks"])


def test_mesh_in_one_process():
    assert mesh.make_mesh().shape == {"data": 1, "model": 1}
    assert mesh.make_mesh().device_mesh is None
    assert mesh.make_mesh().data_group is None
    with pytest.raises(ValueError, match="mesh 8x1x1 != 1 devices"):
        mesh.make_mesh({"data": 8})
    assert mesh.local_device_count() == 1
    assert mesh.batch_sharding(mesh.make_mesh(), 16) == slice(0, 16)


# -- global BatchNorm ------------------------------------------------------

def _flax_bn(inp):
    """flax ``nn.BatchNorm`` (the JAX package's default BN, NHWC) on the
    whole batch: y, dx, dscale, dbias and the new running statistics."""
    import flax.linen as nn

    x = jnp.asarray(inp["x"].transpose(0, 2, 3, 1))
    w = jnp.asarray(inp["w"].transpose(0, 2, 3, 1))
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(inp["scale"]),
                            "bias": jnp.asarray(inp["bias"])},
                 "batch_stats": {"mean": jnp.zeros(4), "var": jnp.ones(4)}}

    def loss(params, x):
        y, new = bn.apply({**variables, "params": params}, x,
                          mutable=["batch_stats"])
        return jnp.sum(y * w), (y, new["batch_stats"])

    (_, (y, stats)), (dp, dx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], x)
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)
    return dict(y=nchw(y), dx=nchw(dx), dscale=np.asarray(dp["scale"]),
                dbias=np.asarray(dp["bias"]), mean=np.asarray(stats["mean"]),
                var=np.asarray(stats["var"]))


def _fused_bn_jax(inp):
    """JAX ``ops/fused_bn.py`` with its Pallas sums kernels in interpret
    mode on the whole batch."""
    x = jnp.asarray(inp["x"].transpose(0, 2, 3, 1))
    w = jnp.asarray(inp["w"].transpose(0, 2, 3, 1))

    def loss(x, s, b):
        y, mean, var = jax_fused_bn.batch_norm_train_stats(
            x, s, b, use_pallas=True, interpret=True)
        return jnp.sum(y * w), (y, mean, var)

    (_, (y, mean, var)), (dx, ds, db) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
            x, jnp.asarray(inp["scale"]), jnp.asarray(inp["bias"]))
    m = x.size // x.shape[-1]
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)
    return dict(y=nchw(y), dx=nchw(dx), dscale=np.asarray(ds),
                dbias=np.asarray(db), mean=0.1 * np.asarray(mean),
                var=0.9 + 0.1 * np.asarray(var) * m / (m - 1))


def _one_process_bn(inp, cls, rows=slice(None)):
    from multimodal_clinical_tpu_torch.models.common import (
        FusedBatchNorm, TorchBatchNorm,
    )

    bn = {"default": TorchBatchNorm, "fused": FusedBatchNorm}[cls](
        4, scale_std=0.0)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["scale"]))
        bn.bias.copy_(torch.from_numpy(inp["bias"]))
    x = torch.from_numpy(inp["x"][rows]).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    y = bn.train()(x)
    (y * torch.from_numpy(inp["w"][rows])).sum().backward()
    return dict(y=y.detach().numpy(), dx=x.grad.numpy(),
                dscale=bn.weight.grad.numpy(), dbias=bn.bias.grad.numpy(),
                mean=bn.running_mean.numpy(), var=bn.running_var.numpy())


def _ranks_bn(group, cls):
    ranks = [_result(group, "bn", r)[cls] for r in range(2)]
    for key in ("dscale", "dbias", "mean", "var"):
        assert np.array_equal(ranks[0][key], ranks[1][key]), key
    return dict(ranks[0], y=np.concatenate([r["y"] for r in ranks]),
                dx=np.concatenate([r["dx"] for r in ranks]))


@pytest.mark.parametrize("cls", ["default", "fused"])
@pytest.mark.parametrize("against", ["one_process", "jax"])
def test_global_batch_norm_on_two_ranks(group, cls, against):
    """``TorchBatchNorm`` and ``FusedBatchNorm`` on two ranks of a global
    batch of 8: the statistics of the global batch in the forward, the
    backward's sums over it, the running statistics from them (biased
    under the default BN, unbiased under the fused one), against one
    process on the whole batch and against JAX on it (flax's
    ``nn.BatchNorm`` for the default, ``ops/fused_bn.py`` with its Pallas
    kernels in interpret mode for the fused)."""
    inp = group["inputs"]["bn"]
    got = _ranks_bn(group, cls)
    if against == "one_process":
        want = _one_process_bn(inp, cls)
    else:
        want = _flax_bn(inp) if cls == "default" else _fused_bn_jax(inp)
    for key in ("y", "dx"):
        H._scaled_close(got[key], want[key], BN_TOL, key)
    for key in ("dscale", "dbias", "mean", "var"):
        np.testing.assert_allclose(got[key], want[key], rtol=BN_TOL,
                                   atol=BN_TOL, err_msg=key)


@pytest.mark.parametrize("cls", ["default", "fused"])
def test_batch_norm_outside_a_step_keeps_local_statistics(group, cls):
    """Outside a step's data axis a BatchNorm on a rank, with the process
    group up, computes what one process computes on the rank's rows
    alone, bit for bit: the group by itself switches nothing."""
    inp = group["inputs"]["bn"]
    for r in range(2):
        got = _result(group, "bn", r)[f"local_{cls}"]
        want = _one_process_bn(inp, cls, slice(4 * r, 4 * (r + 1)))
        for key, value in want.items():
            assert np.array_equal(got[key], value), (r, key)


def test_random_draws_are_the_global_batchs(group):
    """Dropout keep masks and SpecAugment bands: each rank's rows of what
    one process draws for the global batch inside a step's data axis, and
    one process's draws for the rank's rows alone outside it."""
    from multimodal_clinical_tpu_torch.engine.state import step_generator
    from multimodal_clinical_tpu_torch.engine.steps import device_dropout
    from multimodal_clinical_tpu_torch.ops.specaugment import (
        spec_augment_masks,
    )

    keep = device_dropout(3, 5)((8, 6), 0.5, torch.device("cpu")).numpy()
    fmask, tmask = (m.numpy() for m in spec_augment_masks(
        step_generator(3, 5), 8, 40, 60, "cpu"))
    for r in range(2):
        got = _result(group, "draws", r)
        rows = slice(4 * r, 4 * (r + 1))
        assert np.array_equal(got["keep"], keep[rows])
        assert np.array_equal(got["fmask"], fmask[rows])
        assert np.array_equal(got["tmask"], tmask[rows])
    local = device_dropout(3, 5)((4, 6), 0.5, torch.device("cpu")).numpy()
    lf, lt = (m.numpy() for m in spec_augment_masks(
        step_generator(3, 5), 4, 40, 60, "cpu"))
    for r in range(2):
        got = _result(group, "draws", r)["local"]
        assert np.array_equal(got["keep"], local)
        assert np.array_equal(got["fmask"], lf)
        assert np.array_equal(got["tmask"], lt)


# -- the steps against JAX's data mesh -------------------------------------

def _fresh_state(group, name):
    """The port's spec and TrainState of a step case at the JAX init's
    weights, and those weights."""
    bench, model_type, switches = STEP_CASES[name]
    args = SimpleNamespace(**_case_args(bench, model_type))
    with pytest.MonkeyPatch.context() as mp:
        port_mod, _ = _narrow(mp, bench, switches)
        spec, _ = port_mod.get_model_spec(args, n_train=N_TRAIN)
        state = create_train_state(spec, args, seed=0, steps_per_epoch=100,
                                   device="cpu")
    from multimodal_clinical_tpu_torch.models.jax_weights import (
        load_jax_variables,
    )

    inp = group["inputs"]["steps"][name]
    load_jax_variables(state.model, inp["params"], inp["stats"])
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    return spec, state, init


def _port_state(group, name, result):
    """A port TrainState holding ``result``'s final state, for the
    harness's ``check_state``."""
    spec, state, init = _fresh_state(group, name)
    state.model.load_state_dict({k: torch.from_numpy(v)
                                 for k, v in result["model"].items()})
    state.optimizer.load_state_dict(result["optimizer"])
    state.ema = torch.from_numpy(result["ema"])
    state.step = result["step"]
    return spec, state, init


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_steps_match_jax_data_mesh(group, name):
    """Two train steps (the second with each rank's shard padded) and an
    eval step on two ranks, against JAX's step over its data mesh on the
    global batch: metrics, parameter updates, momentum, BN buffers, EMA,
    the QMF History and (EVAL_CASES) the eval outputs; both ranks hold the
    same."""
    r0, r1 = (_result(group, f"step_{name}", r) for r in range(2))
    jrun = group["jax"][name]
    assert r0["metrics"] == r1["metrics"]
    for key, value in r0["model"].items():
        assert np.array_equal(value, r1["model"][key]), key
    for step, (m, jm) in enumerate(zip(r0["metrics"], jrun["jmetrics"])):
        assert set(m) == set(jm), (sorted(m), sorted(jm))
        for k in m:
            if k in H.CONTINUOUS:
                np.testing.assert_allclose(m[k], jm[k], rtol=H.LOSS_RTOL,
                                           err_msg=f"step {step} {k}")
            else:
                assert m[k] == jm[k], (step, k, m[k], jm[k])
    assert [m["valid_count"] for m in r0["metrics"]] == [
        GLOBAL_B, sum(TAIL_REAL)]
    masked = STEP_CASES[name][0] == "vggsound"
    assert r0["masks_drawn"] == (2 if masked else 0)
    assert bool(jrun["drawn"]["jax"]) == masked
    assert (jrun["noise_calls"] > 0) == (name == "ogm_ge")
    spec, state, init = _port_state(group, name, r0)
    H.check_state(dict(state=state, jstate=jrun["jstate"], init=init,
                       spec=spec, grads=[]))
    if name in EVAL_CASES:
        H.check_eval(dict(out=r0["out"], jout=jrun["jout"]))
    if name == "qmf":
        for got, attr in zip(r0["qmf"], ("qmf_correctness",
                                         "qmf_confidence")):
            want = np.asarray(getattr(jrun["jstate"], attr))
            np.testing.assert_allclose(got, want, rtol=H.TABLE_RTOL,
                                       atol=H.TABLE_ATOL, err_msg=attr)
            seen = np.concatenate([b["idx"][b["valid"] > 0] for b in
                                   group["inputs"]["steps"][name]["batches"]])
            assert (got[:, seen] != 0).all()
            assert not np.delete(got, seen, axis=1).any()
    else:
        assert r0["qmf"] is None


# -- FSDP ------------------------------------------------------------------

def test_fsdp_holds_shares_and_equals_data_parallelism(group):
    """Under FSDP each rank holds half of every leaf the rule shards and
    half of its momentum, and two steps give what data parallelism gives
    bit for bit: metrics, every parameter and buffer, the momentum."""
    dp, fs = _result(group, "step_jprobas"), _result(group, "fsdp")
    assert fs["shards"], "no leaf was sharded"
    for key, (shard, full, momentum) in fs["shards"].items():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sharding, "_FSDP_MIN_SIZE", FSDP_MIN)
            d = sharding.fsdp_dim(full, 2, None)
        assert d >= 0 and shard == momentum, key
        assert shard[d] * 2 == full[d] and all(
            a == b for i, (a, b) in enumerate(zip(shard, full)) if i != d)
        assert np.prod(full) >= FSDP_MIN, key
    assert fs["metrics"] == dp["metrics"]
    for key, value in dp["model"].items():
        assert np.array_equal(fs["model"][key], value), key
    for i, entry in dp["optimizer"]["state"].items():
        got = fs["optimizer"]["state"][i]
        assert torch.equal(got["momentum_buffer"], entry["momentum_buffer"])
    assert np.array_equal(fs["out"]["logits_stack"], dp["out"][
        "logits_stack"])


def test_fsdp_checkpoint_loads_in_one_process(group):
    """The checkpoint the FSDP run's rank 0 wrote holds the full tree: a
    world-1 state restores it with every parameter, buffer and momentum
    equal to the data-parallel run's final ones."""
    dp = _result(group, "step_jprobas")
    _, state, _ = _fresh_state(group, "jprobas")
    restored = BestCheckpointer(group["work"] / "fsdp_ckpt").restore_last(
        state)
    assert restored.step == 2
    for key, value in restored.model.state_dict().items():
        assert np.array_equal(value.numpy(), dp["model"][key]), key
    params = [p for g in restored.optimizer.param_groups for p in g["params"]]
    for i, entry in dp["optimizer"]["state"].items():
        assert torch.equal(restored.optimizer.state[params[i]][
            "momentum_buffer"], entry["momentum_buffer"])


# -- the feed and the CLI --------------------------------------------------

def test_rank_streams_are_jax_host_shards(group):
    """Each rank's stream of every split, as ``build_loaders`` gives it,
    is the JAX sampler's for that host (13 rows wrap-padded to 14); the
    union of the ranks' is the global stream; each rank feeds half the
    batch; a batch the ranks do not divide raises JAX's error."""
    labels = (np.arange(13) % 3).astype(np.int32)
    jax_samplers = {
        "weighted": lambda r: jax_sampler.WeightedSampler(
            labels, seed=5, process_index=r, process_count=2),
        "random": lambda r: jax_sampler.RandomSampler(
            13, seed=6, process_index=r, process_count=2),
        "sequential": lambda r: jax_sampler.SequentialSampler(
            13, process_index=r, process_count=2)}
    for kind, make in jax_samplers.items():
        for epoch in (0, 1):
            union = []
            for r in range(2):
                got = _result(group, "streams", r)[kind][epoch]
                want = make(r).indices(epoch)
                assert np.array_equal(got, want), (kind, epoch, r)
                union.append(got)
            whole = make(0)
            whole.process_count = 1
            stream = whole.indices(epoch)
            padded = np.concatenate([stream, stream[:1]])
            assert np.array_equal(np.stack(union, 1).reshape(-1), padded)
    streams = _result(group, "streams")
    assert streams["batch_size"] == 2
    assert streams["bs5"] == "batch_size 5 not divisible by data-axis size 2"
    assert streams["bs7"].startswith("batch_size 7 not divisible")


def _narrow_cli(mp):
    mp.setitem(port_syn.BENCHMARK_SHAPES, "vggsound", CLI_SHAPES)
    mp.setattr(port_zoo, "ResNetEncoder", functools.partial(
        ResNetEncoder, stage_sizes=(1, 1, 1, 1)))
    mp.setattr(vggsound, "CremadFusionNet", functools.partial(
        port_zoo.CremadFusionNet, width=4))


def test_cli_on_two_ranks_matches_one(group, tmp_path):
    """``run_training`` with ``dist_coordinator``, two processes and
    ``mesh_shape: {data: 2}`` on the narrowed VGGSound twin: each rank fed
    its JAX host shard of every split; the test summary within CLI_RTOL of
    a one-process run's; rank 0 alone wrote (one row per epoch in
    ``metrics.jsonl``, rank 1's logger and checkpointer not writing)."""
    r0, r1 = (_result(group, "cli", r) for r in range(2))
    assert r0["summary"] == r1["summary"]
    assert r0["writes"] == (True, True) and r1["writes"] == (False, False)
    with pytest.MonkeyPatch.context() as mp:
        _narrow_cli(mp)
        fed = []
        host_batches = run.Loader._host_batches

        def recording(self):
            for batch in host_batches(self):
                fed.append((len(self.dataset), batch["idx"].numpy().copy(),
                            batch["valid"].numpy().copy()))
                yield batch

        mp.setattr(run.Loader, "_host_batches", recording)
        one = port_main.run_training(
            [*CLI_ARGV, "--set", f"ckpt_dir={tmp_path}",
             "--set", f"data_path={tmp_path}/none"], device="cpu")
    assert set(one) == set(r0["summary"])
    for key, value in one.items():
        np.testing.assert_allclose(r0["summary"][key], value, rtol=CLI_RTOL,
                                   err_msg=key)
    # the same rows each global step (the twin's splits are multiples of
    # the batch): the ranks' rows together are the one process's batch
    assert len(r0["fed"]) == len(r1["fed"]) == len(fed) == 4 + 2 + 2
    for (n, i0, v0), (_, i1, v1), (_, i, v) in zip(r0["fed"], r1["fed"],
                                                   fed):
        assert v0.all() and v1.all() and v.all() and len(i0) == 8
        assert sorted(np.concatenate([i0, i1])) == sorted(i), n
    rows = [line for line in (group["work"] / "cli").glob(
        "*/metrics.jsonl")]
    assert len(rows) == 1
    import json

    epochs = [json.loads(line).get("epoch") for line in
              rows[0].read_text().splitlines()]
    assert [e for e in epochs if e is not None] == [0, -1]


@pytest.mark.parametrize("bench", [
    "avmnist", "mimic", "mustard", "cremad", "ave", "enrico", "fakenews",
    "food101", "food101_legacy"])
def test_every_benchmark_trains_on_two_ranks_under_fsdp(group, bench):
    """Each benchmark's twin (narrowed as its own CLI test narrows it)
    through the CLI for one epoch on the two ranks with ``mesh_shape:
    {data: 2}`` and ``fsdp: true``: FSDP sharded some leaves (at least
    1024 elements here), the ranks' test summaries are equal and
    finite."""
    r0, r1 = (_result(group, "benchmarks", r)[bench] for r in range(2))
    assert "error" not in r0, r0.get("error")
    assert "error" not in r1, r1.get("error")
    assert r0["sharded"] > 0 and r0["sharded"] == r1["sharded"]
    assert r0["summary"] == r1["summary"]
    assert "test_epoch/test_avg_acc" in r0["summary"]
    assert all(np.isfinite(v) for v in r0["summary"].values())


def test_multi_process_sweep_is_refused(group):
    """``num_seeds > 1`` in a group of two raises, naming what to do (the
    JAX ``engine/multiseed.py:185`` refusal)."""
    msg = _result(group, "refusal")
    assert msg is not None and "run one seed per process" in msg
