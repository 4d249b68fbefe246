"""Guards of the PyTorch port: what it imports, where its entry points run,
which switches it takes, and that its CUDA-only wrappers refuse a CPU
tensor."""

import ast
import math
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import multimodal_clinical_tpu_torch
from multimodal_clinical_tpu_torch.benchmarks import vggsound
from multimodal_clinical_tpu_torch.benchmarks.vggsound_fixture import (
    build_vggsound_bench,
)
from multimodal_clinical_tpu_torch.engine import multiseed
from multimodal_clinical_tpu_torch.engine.spec import ModelSpec
from multimodal_clinical_tpu_torch.engine.state import create_train_state
from multimodal_clinical_tpu_torch.engine.steps import make_eval_step
from multimodal_clinical_tpu_torch.models.resnet import ResNetEncoder
from multimodal_clinical_tpu_torch.models.zoo import CremadFusionNet
from multimodal_clinical_tpu_torch.models.common import FusedBatchNorm
from multimodal_clinical_tpu_torch.ops import (
    cuda_bn_stats, cuda_conv3x3, cuda_fused_bn, cuda_identity, cuda_maxpool,
    cuda_spectrogram,
)
from multimodal_clinical_tpu_torch.utils.device import resolve_device

torch.set_num_threads(2)

PACKAGE = Path(multimodal_clinical_tpu_torch.__file__).parent
MODULES = sorted(p.relative_to(PACKAGE).as_posix()
                 for p in PACKAGE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "multimodal_clinical_tpu",
             "yaml", "ml_dtypes", "PIL", "wandb", "orbax"}


def _module_name(rel):
    parts = rel[:-3].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["multimodal_clinical_tpu_torch", *parts])


def _imported_roots(path):
    """Top-level names of every absolute import in the file at ``path``."""
    roots = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.append(node.module.split(".")[0])
    return roots


# PIL decodes frames where the JAX package uses it (its
# ``data/imageops.py`` and ``tools/preprocess.py``) and encodes the disk
# corpora's and the parity fixtures' JPEGs; in each only inside the
# functions that need it, so no import of the port loads it
PIL_MODULES = {"data/imageops.py", "benchmarks/disk_fixture.py",
               "tools/preprocess.py", "tools/parity_run.py"}


@pytest.mark.parametrize("rel", MODULES)
def test_module_imports_nothing_of_jax(rel):
    allowed = {"PIL"} if rel in PIL_MODULES else set()
    for name in _imported_roots(PACKAGE / rel):
        assert name not in FORBIDDEN - allowed, (rel, name)


def test_op_registration_loads_no_gpu_toolchain():
    """Importing the port registers ``mmct::log_spectrogram`` and builds
    nothing: no nvcc run, no library loaded, no ``triton`` imported."""
    code = ("import sys, subprocess, torch\n"
            "def refuse(*a, **k):\n"
            "    raise AssertionError(f'spawned {a[0] if a else k}')\n"
            "subprocess.run = subprocess.Popen = refuse\n"
            "from multimodal_clinical_tpu_torch.benchmarks import vggsound\n"
            "from multimodal_clinical_tpu_torch.ops import "
            "cuda_spectrogram\n"
            "assert torch.ops.mmct.log_spectrogram.default is not None\n"
            "assert cuda_spectrogram._lib.cache_info().currsize == 0\n"
            "bad = [m for m in sys.modules if m.split('.')[0] == 'triton']\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=PACKAGE.parent)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_log_spectrogram_op_cuda_key_is_the_kernel():
    """The operator's CPU implementation is the plain version; its CUDA
    implementation is the kernel's wrapper, which raises for a tensor it
    cannot launch on rather than fall back to the plain version."""
    wave = torch.randn(2, 3000)
    from multimodal_clinical_tpu_torch.ops import spectrogram

    assert torch.equal(cuda_spectrogram.log_spectrogram(wave),
                       spectrogram.log_spectrogram(wave))
    with pytest.raises(ValueError, match="CUDA tensor"):
        torch.ops.mmct.log_spectrogram.default._op_dk(
            torch._C.DispatchKey.CUDA, wave, 256, 128, 1e-7)


def test_chip_smoke_imports_nothing_of_jax():
    roots = _imported_roots(PACKAGE.parent / "chip_smoke.py")
    assert "multimodal_clinical_tpu_torch" in roots
    assert not FORBIDDEN.intersection(roots), roots


def test_importing_every_module_loads_no_jax():
    """The same in a fresh interpreter, through ``sys.modules``: catches an
    import made by name at run time as well."""
    names = [_module_name(rel) for rel in MODULES]
    code = ("import importlib, sys\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=PACKAGE.parent)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_native_binding_never_spawns_make(monkeypatch):
    """The port loads the committed ``native/libfastdata.so`` as it is: no
    subprocess, so ``native/`` is never rebuilt."""
    import subprocess as sp

    from multimodal_clinical_tpu_torch.utils import native

    def refuse(*args, **kwargs):
        raise AssertionError(f"spawned {args[0] if args else kwargs}")

    for name in ("run", "Popen", "call", "check_call", "check_output"):
        monkeypatch.setattr(sp, name, refuse)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    native.available()  # loads the library or reports it unavailable
    assert native._tried
    assert "subprocess" not in _imported_roots(PACKAGE / "utils/native.py")


def test_avdecode_binding_never_spawns_make(monkeypatch):
    """As the native binding: ``native/libavdecode.so`` is loaded as it
    is, or reported unavailable, and never built."""
    import subprocess as sp

    from multimodal_clinical_tpu_torch.utils import avdecode

    def refuse(*args, **kwargs):
        raise AssertionError(f"spawned {args[0] if args else kwargs}")

    for name in ("run", "Popen", "call", "check_call", "check_output"):
        monkeypatch.setattr(sp, name, refuse)
    monkeypatch.setattr(avdecode, "_lib", None)
    monkeypatch.setattr(avdecode, "_tried", False)
    avdecode.available()
    assert avdecode._tried
    assert "subprocess" not in _imported_roots(PACKAGE / "utils/avdecode.py")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_cuda_unless_given_cpu(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_vggsound_bench(batch=2, num_classes=3, num_frames=1,
                             image_size=32, samples=4000, width=8)
    spec = ModelSpec(module=CremadFusionNet(3, width=8), contract="jprobas")
    args = SimpleNamespace(num_classes=3, learning_rate=0.01)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(spec, args, seed=0, steps_per_epoch=1)
    state = create_train_state(spec, args, seed=0, steps_per_epoch=1,
                               device="cpu")
    assert next(state.model.parameters()).device.type == "cpu"
    assert state.ema.device.type == "cpu"
    # the multi-seed sweep: its run, state and loader
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multiseed.run_multiseed(args, vggsound, [0, 1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multiseed.create_multiseed_state(spec, args, [0, 1], 1)
    sweep = multiseed.create_multiseed_state(spec, args, [0, 1], 1,
                                             device="cpu")
    assert {t.device.type for t in (*sweep.params.values(), sweep.ema)} == {
        "cpu"}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multiseed.MultiSeedLoader([], 1, [])


@pytest.mark.parametrize("tool,argv", [
    ("predict", ["--dir", "mimic", "--ckpt", "{tmp}"]),
    ("export", ["--dir", "mimic", "--out", "{tmp}"]),
    ("noise_sweep", ["--out-dir", "{tmp}"]),
    ("parity_run", ["--dir", "mimic", "--allow-synthetic"]),
    ("preprocess", ["ave-audio", "--data-dir", "{tmp}"]),
])
def test_tools_run_on_cuda_unless_given_cpu(no_cuda, tmp_path, tool, argv):
    """Each tool that uses the device asks for CUDA by default and raises
    without it, before it reads or trains anything."""
    import importlib

    main = importlib.import_module(
        f"multimodal_clinical_tpu_torch.tools.{tool}").main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([a.format(tmp=tmp_path) for a in argv])


def test_vggsound_fixture_steps_on_the_cpu():
    """The fixture at a tiny size, on the CPU: two train steps and one eval
    step through the plain spectrogram, no kernel launch.  fp32: PyTorch's
    CPU bf16 convolution returns NaN in some calls at one of this size's
    shapes (channels_last input (2, 32, 9, 2), 3x3, stride 2),
    a fault of the CPU library that the card's bf16 path does not share."""
    train_step, state, batch, spec = build_vggsound_bench(
        batch=2, num_classes=3, device="cpu", num_frames=1, image_size=32,
        samples=4000, width=8, frames_bf16=False, dtype=None)
    before = cuda_spectrogram.launch_log_spectrogram.launches
    for _ in range(2):
        state, metrics = train_step(state, batch)
    assert state.step == 2
    assert set(metrics) == {
        "train_loss", "train_acc", "valid_count", "train_x1_acc_uncal",
        "train_x1_acc", "train_x2_acc_uncal", "train_x2_acc"}
    assert math.isfinite(float(metrics["train_loss"]))
    out = make_eval_step(spec)(state, batch)
    assert out["logits_stack"].shape == (2, 2, 3)
    assert math.isfinite(float(out["loss"]))
    assert cuda_spectrogram.launch_log_spectrogram.launches == before


def test_fixture_weights_are_drawn_from_the_seed():
    def weights():
        _, state, _, _ = build_vggsound_bench(
            batch=1, num_classes=3, device="cpu", num_frames=1,
            image_size=32, samples=1000, width=8)
        return [p.detach().clone() for p in state.model.parameters()]

    assert all(torch.equal(a, b) for a, b in zip(weights(), weights()))


@pytest.mark.parametrize("kwargs,match", [
    (dict(stem_space_to_depth=True), "item 20"),
])
def test_resnet_switches_not_ported_yet_raise(kwargs, match):
    """The switch that raised until ROADMAP's ``match`` was ported builds
    now, with the default path's state_dict names; what still raises is a
    remat policy the JAX package does not have."""
    enc = ResNetEncoder(1, width=8, **kwargs)
    assert set(enc.state_dict()) == set(ResNetEncoder(1, width=8).state_dict())
    with pytest.raises(ValueError, match="remat"):
        ResNetEncoder(1, width=8, remat="all", **kwargs)


def test_unknown_pool_kernel_raises():
    with pytest.raises(ValueError, match="pool_kernel"):
        ResNetEncoder(1, width=8, pool_kernel="triton")


@pytest.mark.parametrize("kwargs", [
    dict(bn_fused=True), dict(pool_kernel="pallas"),
    dict(stem_space_to_depth=True), dict(remat="convs"), dict(remat="none"),
])
def test_resnet_switches_build(kwargs):
    """Each switch builds its modules, with the default path's state_dict
    names, and the encoder runs a train-mode pass on the CPU."""
    enc = ResNetEncoder(1, stage_sizes=(1, 1), width=8, **kwargs)
    default = ResNetEncoder(1, stage_sizes=(1, 1), width=8)
    assert set(enc.state_dict()) == set(default.state_dict())
    fused = [m for m in enc.modules() if isinstance(m, FusedBatchNorm)]
    assert len(fused) == (6 if kwargs.get("bn_fused") else 0)
    assert enc.pool_kernel == kwargs.get("pool_kernel", "xla")
    x = torch.randn(2, 17, 19, 1, requires_grad=True)
    enc(x).sum().backward()
    assert x.grad.shape == x.shape


@pytest.mark.parametrize("call", [
    lambda: cuda_fused_bn.launch_channel_sums(torch.zeros(4, 8)),
    lambda: cuda_fused_bn.launch_bwd_sums(
        torch.zeros(4, 8), torch.zeros(4, 8), torch.zeros(8),
        torch.ones(8)),
    lambda: cuda_maxpool.launch_pool_fwd(torch.zeros(1, 4, 4, 8)),
    lambda: cuda_maxpool.launch_pool_bwd(
        torch.zeros(1, 2, 2, 8), torch.zeros(1, 2, 2, 8, dtype=torch.uint8),
        4, 4),
    lambda: cuda_spectrogram.launch_log_spectrogram(torch.zeros(2, 3000)),
    lambda: cuda_identity.launch_identity(torch.zeros(1, 4, 4, 8)),
    lambda: cuda_bn_stats.launch_bn_stats(torch.zeros(1, 4, 4, 8)),
    lambda: cuda_conv3x3.launch_conv3x3(
        torch.zeros(1, 4, 4, 16, dtype=torch.bfloat16),
        torch.zeros(3, 3, 16, 16, dtype=torch.bfloat16)),
], ids=["bn_sums", "bn_bwd_sums", "pool_fwd", "pool_bwd", "log_spectrogram",
        "identity_copy", "bn_stats", "conv3x3"])
def test_cuda_wrappers_refuse_a_cpu_tensor(call):
    """A kernel wrapper launches its kernel or raises: no plain fallback."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()


@pytest.mark.parametrize("model_type", ["jlogits", "jprobas", "ensemble"])
def test_vggsound_model_spec_serves_its_three_types(model_type):
    args = SimpleNamespace(num_classes=3, compute_dtype="bfloat16",
                           model_type=model_type)
    spec, _ = vggsound.get_model_spec(args, n_train=10)
    assert spec.contract == model_type
    assert spec.device_preprocess is vggsound.device_preprocess
    assert spec.module.x1_classifier.dtype is torch.bfloat16


def test_vggsound_model_spec_raises_for_an_unknown_type():
    with pytest.raises(NotImplementedError, match="ogm_ge"):
        vggsound.get_model_spec(SimpleNamespace(num_classes=3,
                                                model_type="ogm_ge"), 10)
