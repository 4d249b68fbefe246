"""The port's serving export (``multimodal_clinical_tpu_torch/tools/
export.py``, ``torch.export``) against the JAX package's
``tools/export.py`` (StableHLO), mirroring ``tests/test_export.py``.

MIMIC's jlogits and jprobas (in fp32: the config's bf16 rounds at other
places in the two frameworks) are exported by both tools from the same
fresh-init weights (the JAX init's, carried into a port checkpoint through
``models/jax_weights.py``) and served on the same inputs: log-probabilities
and the stacked logits within 1e-5 absolute (the GRU's fp32 sums in
another order, measured ~1e-6), the same predictions.  The port's
artifact against its own eval fusion in process: 1e-6.  A narrowed
VGGSound artifact, whose input is the raw waveform, must hold the
``mmct::log_spectrogram`` operator in its graph and serve the same
outputs when loaded in a fresh interpreter.
"""

import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_clinical_tpu_torch.benchmarks import get_benchmark
from multimodal_clinical_tpu_torch.benchmarks import vggsound
from multimodal_clinical_tpu_torch.config import setup_configs
from multimodal_clinical_tpu_torch.data.core import ArrayDataset
from multimodal_clinical_tpu_torch.engine.checkpoint import BestCheckpointer
from multimodal_clinical_tpu_torch.engine.run import DataBundle
from multimodal_clinical_tpu_torch.engine.state import create_train_state
from multimodal_clinical_tpu_torch.models.jax_weights import (
    load_jax_variables,
)
from multimodal_clinical_tpu_torch.models.zoo import CremadFusionNet
from multimodal_clinical_tpu_torch.tools import export

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

torch.set_num_threads(2)

JAX_ATOL = 1e-5
SELF_ATOL = 1e-6


def _args(dir_, **over):
    argv = ["--dir", dir_]
    for k, v in over.items():
        argv += ["--set", f"{k}={v}"]
    return setup_configs(argv)


def _inputs(meta, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=[n] + i["shape"][1:]).astype(i["dtype"])
            for i in meta["inputs"]]


@pytest.mark.parametrize("model_type", ["jlogits", "jprobas"])
def test_export_round_trip_matches_jax(tmp_path, model_type):
    from multimodal_clinical_tpu.benchmarks import get_benchmark as jax_bench
    from multimodal_clinical_tpu.config import setup_configs as jax_setup
    from multimodal_clinical_tpu.engine.run import init_state_on_mesh
    from multimodal_clinical_tpu.parallel.mesh import make_mesh
    from tools.export import export_benchmark as jax_export
    from tools.export import load_artifact as jax_load

    jargs = jax_setup(["--dir", "mimic", "--set", f"model_type={model_type}",
                       "--set", "batch_size=8",
                       "--set", "compute_dtype=float32"])
    jax_dir = str(tmp_path / "jax")
    jax_export(jargs, jax_bench("mimic"), ckpt_dir=None, which="best",
               batch=4, out_dir=jax_dir, platforms=["cpu"])
    jdata = jax_bench("mimic").get_data(jargs)
    jspec, jopt = jax_bench("mimic").get_model_spec(
        jargs, n_train=len(jdata.train))
    jstate = init_state_on_mesh(jspec, jargs, jdata, make_mesh(None), jopt)

    args = _args("mimic", model_type=model_type, batch_size=8,
                 compute_dtype="float32")
    benchmark = get_benchmark("mimic")
    data = benchmark.get_data(args)
    spec, opt_kwargs = benchmark.get_model_spec(args,
                                                n_train=len(data.train))
    state = create_train_state(spec, args, 0, 1, device="cpu", **opt_kwargs)
    load_jax_variables(state.model, jax.device_get(jstate.params),
                       jax.device_get(jstate.batch_stats))
    ckpt = str(tmp_path / "ckpt")
    BestCheckpointer(ckpt).maybe_save(state, 1.0)
    out_dir = str(tmp_path / "port")
    export.export_benchmark(args, benchmark, ckpt, "best", 4, out_dir,
                            device="cpu")

    meta = json.load(open(os.path.join(out_dir, "meta.json")))
    jmeta = json.load(open(os.path.join(jax_dir, "meta.json")))
    for key in ("benchmark", "model_type", "contract", "num_classes",
                "batch", "outputs", "logits_stack_semantics"):
        assert meta[key] == jmeta[key], key
    assert [(i["name"], i["shape"], i["dtype"]) for i in meta["inputs"]] == [
        (i["name"], i["shape"], i["dtype"]) for i in jmeta["inputs"]]
    assert meta["op_module"] == "multimodal_clinical_tpu_torch.ops." \
        "cuda_spectrogram"
    inputs = _inputs(meta, 4, 0)
    served = export.load_artifact(out_dir)(
        *[torch.from_numpy(a) for a in inputs])
    want = jax_load(jax_dir)(*[jnp.asarray(a) for a in inputs])
    for key in ("logprobs", "logits_stack"):
        np.testing.assert_allclose(served[key].numpy(),
                                   np.asarray(want[key]), rtol=0,
                                   atol=JAX_ATOL, err_msg=key)
    np.testing.assert_array_equal(served["pred"].numpy(),
                                  np.asarray(want["pred"]))
    assert served["pred"].dtype == torch.int32
    # the artifact against the same program run in process
    direct = export.ServingProgram(spec, state.model, ["x1", "x2"])
    with torch.no_grad():
        ref = direct(*[torch.from_numpy(a) for a in inputs])
    for key in ("logprobs", "logits_stack"):
        torch.testing.assert_close(served[key], ref[key], rtol=0,
                                   atol=SELF_ATOL)
    if model_type == "jprobas":
        # per-row log(softmax + eps): each row's probabilities sum to ~1
        stack = served["logits_stack"].double().exp().sum(-1)
        torch.testing.assert_close(stack, torch.ones_like(stack), rtol=0,
                                   atol=1e-3)


def test_export_cli_smoke(tmp_path):
    """The CLI without a checkpoint (the fresh-init warning path)."""
    out = str(tmp_path / "cli_artifact")
    export.main(["--dir", "avmnist", "--batch", "2", "--out", out,
                 "--device", "cpu", "--set", "batch_size=8"])
    assert os.path.exists(os.path.join(out, "serving.pt2"))
    meta = json.load(open(os.path.join(out, "meta.json")))
    assert meta["benchmark"] == "avmnist"
    assert meta["platforms"] == ["cpu"]
    got = export.load_artifact(out)(
        *[torch.from_numpy(a) for a in _inputs(meta, 2, 1)])
    assert got["pred"].shape == (2,)
    assert torch.isfinite(got["logprobs"]).all()


def test_export_symbolic_batch(tmp_path):
    """--batch sym: one artifact serves any batch size, one included."""
    out = str(tmp_path / "sym_artifact")
    export.main(["--dir", "mimic", "--batch", "sym", "--out", out,
                 "--device", "cpu", "--set", "batch_size=8"])
    meta = json.load(open(os.path.join(out, "meta.json")))
    assert meta["batch"] == "sym"
    assert meta["inputs"][0]["shape"][0] == "b"
    served = export.load_artifact(out)
    for n in (1, 3, 9):
        got = served(*[torch.from_numpy(a) for a in _inputs(meta, n, n)])
        assert got["pred"].shape == (n,)


def _waveform_bundle(classes):
    """VGGSound's raw layout at a narrow size: 4000-sample waveforms and
    one uint8 frame of 32 x 32."""
    class WaveDataset(ArrayDataset):
        def gather(self, indices):
            out = super().gather(indices)
            out["x1_waveform"] = out.pop("x1")
            return out

    rng = np.random.default_rng(0)

    def make(n):
        return WaveDataset(
            [rng.normal(scale=0.1, size=(n, 4000)).astype(np.float32),
             rng.integers(0, 256, size=(n, 1, 32, 32, 3), dtype=np.uint8)],
            rng.integers(0, classes, n).astype(np.int32))

    return DataBundle(make(8), make(4), make(4))


def test_vggsound_artifact_runs_the_log_spectrogram_op_in_a_fresh_process(
        tmp_path):
    args = SimpleNamespace(dir="vggsound", num_classes=5, batch_size=4,
                           model_type="jprobas", seed=0, learning_rate=0.01,
                           use_scheduler=False)
    bundle = _waveform_bundle(5)

    def get_model_spec(a, n_train):
        spec, opt = vggsound.get_model_spec(a, n_train)
        return dataclasses.replace(
            spec, module=CremadFusionNet(5, width=8)), opt

    benchmark = SimpleNamespace(get_data=lambda _: bundle,
                                get_model_spec=get_model_spec)
    out_dir = str(tmp_path / "vgg")
    export.export_benchmark(args, benchmark, None, "best", "sym", out_dir,
                            device="cpu")
    program = torch.export.load(os.path.join(out_dir, "serving.pt2"))
    targets = [n.target for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count(torch.ops.mmct.log_spectrogram.default) == 1
    meta = json.load(open(os.path.join(out_dir, "meta.json")))
    assert [i["name"] for i in meta["inputs"]] == ["x1_waveform", "x2"]
    sample = bundle.test.gather(np.arange(3))
    np.savez(tmp_path / "inputs.npz", sample["x1_waveform"], sample["x2"])
    here = export.load_artifact(out_dir)(
        torch.from_numpy(sample["x1_waveform"]),
        torch.from_numpy(sample["x2"]))
    code = (
        "import numpy as np, torch\n"
        "from multimodal_clinical_tpu_torch.tools.export import "
        "load_artifact\n"
        f"d = np.load({str(tmp_path / 'inputs.npz')!r})\n"
        f"out = load_artifact({out_dir!r})(*[torch.from_numpy(d[k]) "
        "for k in ('arr_0', 'arr_1')])\n"
        f"np.savez({str(tmp_path / 'served.npz')!r}, "
        "**{k: v.numpy() for k, v in out.items()})\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    served = np.load(tmp_path / "served.npz")
    for key in ("logprobs", "logits_stack", "pred"):
        np.testing.assert_array_equal(served[key], here[key].numpy())
    assert here["pred"].shape == (3,)
