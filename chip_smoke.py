#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``multimodal_clinical_tpu_torch``) on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the repository root.

Phases, each of which raises on failure:

1. device: CUDA is required; prints the card's name and power limit;
2. build: compiles every CUDA source of the port with nvcc for sm_90a;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shape and at a general one, with its times beside its
   bound and the library call that computes the same function;
4. card against CPU: a narrow fp32 VGGSound step, two train steps from the
   same weights on the card and on the CPU;
5. main path: the VGGSound jprobas train step at batch 224 (two ResNet18
   towers, bf16, 309 classes), one warm-up step, timed steps, one eval
   step; every kernel of the path must have launched.

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits 2 and prints no
result.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BATCH, CLASSES = 224, 309
WARMUP_STEPS, TIMED_STEPS, EVAL_STEPS = 1, 5, 1
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 outside the
# tensor cores.  Both assume the full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# kernel vs plain version, both fp32 sums of the same 256 products in
# another order: |X| agrees to a few ulps of the batch's largest |X|; the
# log is held tight only where |X| >= 1e-3 of the batch's rms (near-zero
# bins turn an ulp of |X| into a large log error).
MAG_TOL = 1e-5
LOG_ATOL = 1e-3
# card against CPU (see phase_card_against_cpu).  fp32, TF32 off: two sums
# of the same terms in another order, amplified by train-mode BN over few
# values.  float64: the loss and EMA are fp32 by design, so each gradient
# starts from fp32 logit gradients (~1e-7 relative), and train-mode BN over
# the 8 values per channel of the video tower's last stage (4 frames of
# 32 x 32 end at 1 x 1) amplifies their cancellation: 1.1e-5 of a
# tensor's largest entry measured on the H100.  A flipped ReLU or max-pool
# decision would show as percents.
CPU_LOSS_RTOL = 1e-4
CPU_BUFFER_RTOL, CPU_BUFFER_ATOL = 1e-4, 1e-5
CPU_EMA_ATOL = 1e-5
F64_LOSS_RTOL = 1e-6
F64_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from multimodal_clinical_tpu_torch.kernels import build

    seconds = build.build()
    for name in build.SOURCES:
        path = build.library_path(name)
        if name in seconds:
            log(f"[build] {name}.cu -> {path}: {seconds[name]:.2f} s\n"
                + path.with_suffix(".log").read_text().strip())
        else:
            log(f"[build] {name}.cu: already built at {path}")


def compare_spectrogram(got: torch.Tensor, want: torch.Tensor):
    """(max abs error of the log over all bins, over the clear bins);
    raises where the kernel and the plain version disagree."""
    got_mag, want_mag = got.exp(), want.exp()
    mag_err = float((got_mag - want_mag).abs().max())
    if not mag_err <= MAG_TOL * float(want_mag.max()):
        raise AssertionError(f"|X| differs by {mag_err}")
    clear = want_mag >= 1e-3 * want_mag.square().mean().sqrt()
    err = (got - want).abs()
    clear_err = float(err[clear].max())
    if not clear_err <= LOG_ATOL:
        raise AssertionError(f"log|X| differs by {clear_err} in clear bins")
    return float(err.max()), clear_err


def phase_kernels(device):
    from multimodal_clinical_tpu_torch.ops import cuda_spectrogram as cs
    from multimodal_clinical_tpu_torch.ops import spectrogram as plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_fft, hop = 256, 128
    rng = np.random.default_rng(0)
    # the main path's shape and data: the fixture's waveform
    wave = torch.from_numpy(rng.normal(scale=0.1, size=(BATCH, 80000)).astype(
        np.float32)).to(device)
    got = cs.launch_log_spectrogram(wave, n_fft, hop)
    torch.cuda.synchronize()
    want = plain.log_spectrogram(wave, n_fft, hop)
    max_err, clear_err = compare_spectrogram(got, want)
    log(f"[kernels] log_spectrogram {tuple(wave.shape)} hop {hop}: "
        f"max |log err| {max_err:.3e}, in clear bins {clear_err:.3e}")
    # general hop and ragged length: no hop == n_fft / 2 assumption
    odd = torch.from_numpy(rng.normal(size=(5, 30001)).astype(
        np.float32)).to(device)
    general_err, _ = compare_spectrogram(
        cs.launch_log_spectrogram(odd, n_fft, 100),
        plain.log_spectrogram(odd, n_fft, 100))
    log(f"[kernels] log_spectrogram (5, 30001) hop 100: max |log err| "
        f"{general_err:.3e}")

    window = torch.hann_window(n_fft, periodic=True, device=device)

    def library():
        return torch.stft(wave, n_fft, hop, window=window, center=True,
                          pad_mode="reflect", return_complex=True
                          ).abs().add(1e-7).log()

    ms = cuda_ms(lambda: cs.launch_log_spectrogram(wave, n_fft, hop))
    plain_ms = cuda_ms(lambda: plain.log_spectrogram(wave, n_fft, hop))
    library_ms = cuda_ms(library)
    b, n = wave.shape
    frames = got.shape[-1]
    bytes_moved = 4 * (b * n + got.numel())
    # fewest operations for the same function: a radix-2 real FFT of each
    # frame (2.5 n log2 n), the window (n) and |X| (3 per bin)
    fft_flops = b * frames * (2.5 * n_fft * math.log2(n_fft) + n_fft
                              + 3 * (n_fft // 2 + 1))
    # what this kernel's DFT formulation executes (log line only: a floor of
    # the formulation, not of the function)
    dft_flops = 2 * b * frames * n_fft * 2 * (n_fft // 2 + 1)
    bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = fft_flops / PEAK_FP32_FLOPS * 1e3
    # "ms" is the contract's name for the kernel's time, "kernel_ms" the
    # same measurement under the name the port's records use
    entry = {
        "name": "log_spectrogram",
        "route": "cuda",
        "source": "multimodal_clinical_tpu_torch/csrc/log_spectrogram.cu",
        "replaces": "multimodal_clinical_tpu/ops/pallas_spectrogram.py:62 "
                    "pallas_log_spectrogram",
        "launches": None,
        "max_abs_err": max_err,
        "max_abs_err_clear_bins": clear_err,
        "max_abs_err_general_hop": general_err,
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }
    log(f"[kernels] log_spectrogram {(b, n)}: {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch.stft {library_ms:.4f} ms, bound "
        f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}); the DFT "
        f"formulation's fp32 operations alone would take "
        f"{dft_flops / PEAK_FP32_FLOPS * 1e3:.4f} ms at peak")
    return [entry]


def _scaled_err(got, want):
    """Largest difference, in units of ``want``'s largest entry."""
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def _narrow_step(dev, dtype, preprocess=None):
    """Two train steps of the narrow fixture on ``dev``: losses, the
    initial and final state_dict, momentum buffers and EMA, on the CPU."""
    from multimodal_clinical_tpu_torch.benchmarks.vggsound_fixture import (
        build_vggsound_bench,
    )

    step, state, batch, spec = build_vggsound_bench(
        batch=2, num_classes=5, device=dev, frames_bf16=False, num_frames=2,
        image_size=32, samples=4000, width=8, dtype=None)
    state.model.to(dtype)
    if preprocess is not None:
        spec.device_preprocess = preprocess
    cpu = lambda t: t.detach().cpu().clone()
    init = {k: cpu(v) for k, v in state.model.state_dict().items()}
    losses = []
    for _ in range(2):
        state, metrics = step(state, batch)
        losses.append(float(metrics["train_loss"]))
    named = dict(state.model.named_parameters())
    return dict(
        losses=losses, init=init,
        final={k: cpu(v) for k, v in state.model.state_dict().items()},
        momentum={k: cpu(state.optimizer.state[p]["momentum_buffer"])
                  for k, p in named.items()},
        ema=cpu(state.ema))


def phase_card_against_cpu(device):
    """The narrow VGGSound step on the card and on the CPU from the same
    seed: same weights, inputs and SpecAugment draws (drawn from a CPU
    generator on both).

    fp32, each device with its own preprocess (the kernel on the card, the
    plain version on the CPU): losses, BN buffers and EMA, which are
    continuous in the inputs.  Parameter updates are not compared in fp32:
    the gradient jumps where a ReLU or max-pool decision sits within
    rounding of its threshold, and cuDNN and the CPU round differently.

    float64, both devices fed the card's preprocessed batch: the same
    forward decisions on both sides, so parameter updates and momentum
    buffers are held tight.  The loss and the EMA stay fp32 by design
    (``engine/contracts.py``), which bounds the agreement at ~1e-7."""
    from multimodal_clinical_tpu_torch.benchmarks import vggsound

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = torch.device("cpu")
    card, host = _narrow_step(device, torch.float32), _narrow_step(
        cpu, torch.float32)
    np.testing.assert_allclose(card["losses"], host["losses"],
                               rtol=CPU_LOSS_RTOL)
    worst = {"buffer": 0.0, "update": 0.0, "momentum": 0.0}
    for key, want in host["final"].items():
        assert torch.equal(card["init"][key], host["init"][key]), key
        if "running" in key:
            np.testing.assert_allclose(card["final"][key].numpy(),
                                       want.numpy(), rtol=CPU_BUFFER_RTOL,
                                       atol=CPU_BUFFER_ATOL, err_msg=key)
            worst["buffer"] = max(worst["buffer"],
                                  _scaled_err(card["final"][key], want))
    np.testing.assert_allclose(card["ema"].numpy(), host["ema"].numpy(),
                               rtol=0, atol=CPU_EMA_ATOL)
    log(f"[card-vs-cpu] fp32 losses card {card['losses']} cpu "
        f"{host['losses']}; BN buffers within {worst['buffer']:.2e}")

    def shared(batch, generator, train):
        out = vggsound.device_preprocess(
            {k: v.to(device) for k, v in batch.items()}, generator, train)
        dev = batch["label"].device
        return {k: (v.double() if k in ("x1", "x2") else v).to(dev)
                for k, v in out.items()}

    card, host = (_narrow_step(device, torch.float64, shared),
                  _narrow_step(cpu, torch.float64, shared))
    np.testing.assert_allclose(card["losses"], host["losses"],
                               rtol=F64_LOSS_RTOL)
    for key, want in host["final"].items():
        if "running" in key:
            np.testing.assert_allclose(card["final"][key].numpy(),
                                       want.numpy(), rtol=F64_TOL,
                                       atol=F64_TOL, err_msg=key)
            continue
        pairs = {"update": (card["final"][key] - card["init"][key],
                            want - host["init"][key]),
                 "momentum": (card["momentum"][key], host["momentum"][key])}
        for what, (got, ref) in pairs.items():
            err = _scaled_err(got, ref)
            worst[what] = max(worst[what], err)
            if not err <= F64_TOL:
                raise AssertionError(f"{key} {what}: card and CPU differ by "
                                     f"{err:.3e} of its largest entry")
    log(f"[card-vs-cpu] float64 losses card {card['losses']} cpu "
        f"{host['losses']}; updates within {worst['update']:.2e}, momentum "
        f"within {worst['momentum']:.2e} of each tensor's largest entry")


def phase_main_path(device, card: str, kernels):
    from multimodal_clinical_tpu_torch.benchmarks.vggsound_fixture import (
        build_vggsound_bench,
    )
    from multimodal_clinical_tpu_torch.engine.steps import make_eval_step
    from multimodal_clinical_tpu_torch.ops import cuda_spectrogram as cs

    launchers = {"log_spectrogram": cs.launch_log_spectrogram}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_step, state, batch, spec = build_vggsound_bench(
        BATCH, CLASSES, device=device)
    eval_step = make_eval_step(spec)
    torch.cuda.synchronize()
    log(f"[main] fixture built in {time.perf_counter() - t0:.1f} s")
    for launcher in launchers.values():
        launcher.launches = 0
    losses, step_ms = [], []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        t = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        elapsed = (time.perf_counter() - t) * 1e3
        losses.append(float(metrics["train_loss"]))
        if i >= WARMUP_STEPS:
            step_ms.append(elapsed)
        log(f"[main] step {i} {'warm-up' if i < WARMUP_STEPS else 'timed'}: "
            f"{elapsed:.1f} ms, loss {losses[-1]:.5f}")
    for _ in range(EVAL_STEPS):
        out = eval_step(state, batch)
        torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in launchers.items()}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite train loss: {losses}")
    stack = out["logits_stack"]
    if stack.shape != (BATCH, 2, CLASSES) or not bool(
            torch.isfinite(stack).all()) or not math.isfinite(
                float(out["loss"])):
        raise AssertionError("eval step output is not finite or misshaped")
    expected = WARMUP_STEPS + TIMED_STEPS + EVAL_STEPS
    for name, count in launches.items():
        if count != expected:
            raise AssertionError(
                f"{name} launched {count} times in {expected} steps")
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
    median = statistics.median(step_ms)
    log(f"[main] {card}: train step median {median:.2f} ms, mean "
        f"{statistics.mean(step_ms):.2f} ms over {TIMED_STEPS} steps "
        f"(each {', '.join(f'{m:.2f}' for m in step_ms)}); "
        f"{BATCH / median * 1e3:.1f} samples/s at batch {BATCH}; eval loss "
        f"{float(out['loss']):.5f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {launches}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"[device] {card}; {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    phase_build()
    kernels = phase_kernels(device)
    phase_card_against_cpu(device)
    phase_main_path(device, card, kernels)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
