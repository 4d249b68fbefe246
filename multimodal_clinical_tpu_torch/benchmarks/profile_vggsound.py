"""Where the time of the VGGSound train step goes, on the card.

    python -m multimodal_clinical_tpu_torch.benchmarks.profile_vggsound

Builds the train-step fixture (batch 224, 309 classes, bf16), runs two
warm-up steps, then traces three steps with ``torch.profiler``
(CPU and CUDA activities).  Prints the device time by kernel family and the
top kernels, the step's wall time, and the device's idle share: one minus
the summed kernel time over the wall time of the traced steps (one stream,
so kernels do not overlap).  Needs a card: the fixture raises without
CUDA.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from .vggsound_fixture import build_vggsound_bench

WARMUP_STEPS, TRACED_STEPS, TOP = 2, 3, 15
# kernel-name fragments -> family, first match wins
FAMILIES = (
    ("log_spectrogram", "log-spectrogram kernel"),
    ("sums_fwd", "BN-sums kernels"), ("sums_partial", "BN-sums kernels"),
    ("sums_finalize", "BN-sums kernels"),
    ("pool_fwd_kernel", "max-pool kernels"),
    ("pool_bwd_kernel", "max-pool kernels"),
    ("conv", "convolution"), ("xmma", "convolution"), ("fprop", "convolution"),
    ("dgrad", "convolution"), ("wgrad", "convolution"),
    ("implicit", "convolution"),
    ("batch_norm", "batch norm"), ("bn_", "batch norm"),
    ("welford", "batch norm"),
    ("max_pool", "max-pool"), ("gemm", "matmul"), ("cutlass", "matmul"),
    ("multi_tensor", "optimizer"), ("reduce", "reductions"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
    ("copy", "copies"), ("memcpy", "copies"), ("memset", "copies"),
)


def family(name: str) -> str:
    low = name.lower()
    for frag, fam in FAMILIES:
        if frag in low:
            return fam
    return "other"


def kernel_times(prof) -> dict:
    """Device microseconds by kernel name in a finished ``profile``."""
    kernels = defaultdict(float)
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] += evt.self_device_time_total
    return kernels


def family_times(kernels: dict) -> dict:
    families = defaultdict(float)
    for name, us in kernels.items():
        families[family(name)] += us
    return families


def main() -> None:
    train_step, state, batch, _ = build_vggsound_bench()
    batch_size = batch["label"].shape[0]
    for _ in range(WARMUP_STEPS):
        state, _ = train_step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACED_STEPS):
            state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    float(metrics["train_loss"])
    kernels = kernel_times(prof)
    busy_ms = sum(kernels.values()) / 1e3
    if not 0 < busy_ms <= wall_ms:
        raise RuntimeError(f"device busy {busy_ms:.3f} ms in {wall_ms:.3f} ms "
                           "of wall time: the trace's kernel times are wrong")
    print(f"[profile] {torch.cuda.get_device_name(0)}; batch {batch_size}, "
          f"{TRACED_STEPS} traced steps: {wall_ms / TRACED_STEPS:.2f} ms per "
          f"step (wall), device busy {busy_ms / TRACED_STEPS:.2f} ms per "
          f"step, idle share {1 - busy_ms / wall_ms:.3f}")
    families = family_times(kernels)
    for fam, us in sorted(families.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {fam:24s} {us / 1e3 / TRACED_STEPS:9.3f} ms/step "
              f"{us / 1e3 / busy_ms:7.1%}")
    print(f"[profile] top {TOP} by device time per step:")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"[profile]   {us / 1e3 / TRACED_STEPS:9.3f} ms  {name[:110]}")


if __name__ == "__main__":
    main()
