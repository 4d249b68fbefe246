"""Per-call times of the switched towers' BN-sums and max-pool kernels on
the card.

    python -m multimodal_clinical_tpu_torch.benchmarks.switched_kernels \
        [--repeat N]

For each BN-sums call of one forward and backward pass of the two switched
towers (``ResNetEncoder(bn_fused=True, pool_kernel="pallas")`` at the main
path's batch: 40 forward and 40 backward calls over the 10 (M, C) shapes of
``BN_CALLS``) and each stem max-pool backward of a train step (``POOL_STEMS``),
on bf16 inputs made on the card from a seed:

* ``device``: the device-only time of one call, from ``torch.profiler``:
  every kernel the call launches, summed, over ``ITERS`` calls;
* ``events``: ``cuda_ms``, CUDA events around ``ITERS`` back-to-back calls,
  which also counts the host's time where it exceeds the device's;
* ``bound``: the bytes the call must move (each input read once, each
  output written once) at the card's 3.35 TB/s.

The shape whose time wandered most between runs, (175616, 256), is measured
``--repeat`` times.  Inputs are made once per shape and stay warm in the
50 MB L2 where they fit, as the towers leave a conv output there.  Needs a
card.  The script only calls the kernels' wrappers, so it runs unchanged
against another checkout of the package (its ``benchmarks/`` directory),
which is how two designs are compared on one card.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from ..ops import cuda_fused_bn, cuda_maxpool

PEAK_BYTES_PER_S = 3.35e12
ITERS = 20
# (M, C) of the BN inputs of one towers pass, and calls per pass: visual
# (batch 896) then audio (batch 224); the backward takes the same shapes
BN_CALLS = (((11239424, 64), 1), ((2809856, 64), 4), ((702464, 128), 5),
            ((175616, 256), 5), ((43904, 512), 5),
            ((4557280, 64), 1), ((1160544, 64), 4), ((300832, 128), 5),
            ((80640, 256), 5), ((22400, 512), 5))
WANDERING = (175616, 256)
# the stem maps the max-pools take, (B, H, W, C)
POOL_STEMS = ((896, 112, 112, 64), (224, 65, 313, 64))


def cuda_ms(fn, iters: int = ITERS) -> float:
    """Mean time per call of ``iters`` back-to-back calls (CUDA events)."""
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


def device_ms(fn, iters: int = ITERS):
    """(device ms per call, {kernel name: device ms per call}) of ``fn``
    from ``torch.profiler``: every kernel it launches, summed.  A kernel's
    time is the median of the launches the trace recorded, times its
    launches per call: on the H100 some traces kept a third of a kernel's
    records, or records shorter than the bytes allow, which read as a time
    below the bound when summed and divided by ``iters``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    launches = collections.defaultdict(list)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            launches[evt.name].append(evt.time_range.elapsed_us())
    if not launches:
        raise RuntimeError("the profiler recorded no device time")
    kernels = {name: statistics.median(us) * max(1, round(len(us) / iters))
               / 1e3 for name, us in launches.items()}
    return sum(kernels.values()), kernels


def bound_ms(bytes_moved: float) -> float:
    return bytes_moved / PEAK_BYTES_PER_S * 1e3


def _bn_inputs(m: int, c: int, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, c, device="cuda", dtype=torch.bfloat16,
                    generator=gen).add_(0.5)
    dy = torch.randn(m, c, device="cuda", dtype=torch.bfloat16,
                     generator=gen)
    mean = torch.full((c,), 0.5, device="cuda")
    rstd = torch.ones(c, device="cuda")
    return x, dy, mean, rstd


def bn_rows(repeat: int):
    """One row per BN shape: per-call times of both sums and their bounds."""
    rows = []
    for (m, c), count in BN_CALLS:
        x, dy, mean, rstd = _bn_inputs(m, c, seed=m)
        reps = repeat if (m, c) == WANDERING else 1
        fwd = [(device_ms(lambda: cuda_fused_bn.launch_channel_sums(x)),
                cuda_ms(lambda: cuda_fused_bn.launch_channel_sums(x)))
               for _ in range(reps)]
        bwd_device, _ = device_ms(
            lambda: cuda_fused_bn.launch_bwd_sums(dy, x, mean, rstd))
        bwd_events = cuda_ms(
            lambda: cuda_fused_bn.launch_bwd_sums(dy, x, mean, rstd))
        n = m * c
        rows.append(dict(
            shape=(m, c), count=count,
            fwd_device=fwd[0][0][0], fwd_kernels=fwd[0][0][1],
            fwd_events=fwd[0][1],
            fwd_repeats=[(d[0], e) for d, e in fwd],
            fwd_bound=bound_ms(2 * n + 8 * c),
            bwd_device=bwd_device, bwd_events=bwd_events,
            bwd_bound=bound_ms(4 * n + 16 * c)))
        del x, dy
    torch.cuda.empty_cache()
    return rows


def pool_rows():
    rows = []
    for stem in POOL_STEMS:
        gen = torch.Generator(device="cuda").manual_seed(3)
        # a post-ReLU stem map: half its entries are tied at zero
        x = torch.randn(stem, device="cuda", dtype=torch.bfloat16,
                        generator=gen).clamp_min_(0)
        y, idx = cuda_maxpool.launch_pool_fwd(x)
        dy = torch.randn(y.shape, device="cuda", dtype=torch.bfloat16,
                         generator=gen)
        h, w = stem[1:3]
        del x

        def bwd():
            return cuda_maxpool.launch_pool_bwd(dy, idx, h, w)

        device, kernels = device_ms(bwd)
        n_in, n_out = h * w * stem[0] * stem[3], y.numel()
        rows.append(dict(shape=stem, device=device, kernels=kernels,
                         events=cuda_ms(bwd),
                         bound=bound_ms(3 * n_out + 2 * n_in)))
        del y, idx, dy
    torch.cuda.empty_cache()
    return rows


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def main(repeat: int = 5) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the switched-kernel timings need a CUDA card")
    card = card_line()
    print(f"[calls] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    bn, pool = bn_rows(repeat), pool_rows()
    totals = {k: sum(r["count"] * r[k] for r in bn) for k in (
        "fwd_device", "fwd_events", "fwd_bound", "bwd_device", "bwd_events",
        "bwd_bound")}
    print("[calls] BN-sums forward, per call (ms): device-only (profiler), "
          "events (cuda_ms), bound, device share of bound; kernels")
    for r in bn:
        kernels = ", ".join(f"{k[:40]} {v:.4f}"
                            for k, v in r["fwd_kernels"].items())
        print(f"[calls]   {r['shape']} x{r['count']}: {r['fwd_device']:.4f} "
              f"{r['fwd_events']:.4f} {r['fwd_bound']:.4f} "
              f"{r['fwd_bound'] / r['fwd_device']:.1%}; {kernels}")
    for r in bn:
        if len(r["fwd_repeats"]) > 1:
            print(f"[calls]   {r['shape']} repeated: " + ", ".join(
                f"{d:.4f} / {e:.4f}" for d, e in r["fwd_repeats"])
                + " (device / events)")
    print("[calls] BN-sums backward, per call (ms): device-only, events, "
          "bound")
    for r in bn:
        print(f"[calls]   {r['shape']} x{r['count']}: {r['bwd_device']:.4f} "
              f"{r['bwd_events']:.4f} {r['bwd_bound']:.4f}")
    print(f"[calls] per towers pass (40 calls each way): forward device "
          f"{totals['fwd_device']:.4f} ms, events {totals['fwd_events']:.4f}, "
          f"bound {totals['fwd_bound']:.4f} "
          f"({totals['fwd_bound'] / totals['fwd_device']:.1%} of it on the "
          f"device); backward device {totals['bwd_device']:.4f}, events "
          f"{totals['bwd_events']:.4f}, bound {totals['bwd_bound']:.4f}")
    for r in pool:
        kernels = ", ".join(f"{k[:40]} {v:.4f}" for k, v in r["kernels"].items())
        print(f"[calls] max-pool backward {r['shape']}: device "
              f"{r['device']:.4f} ms, events {r['events']:.4f}, bound "
              f"{r['bound']:.4f} ({r['bound'] / r['device']:.1%}); {kernels}")
    pool_total = {k: sum(r[k] for r in pool)
                  for k in ("device", "events", "bound")}
    print(f"[calls] max-pool backward, 2 calls per train step: device "
          f"{pool_total['device']:.4f} ms, events {pool_total['events']:.4f}, "
          f"bound {pool_total['bound']:.4f} "
          f"({pool_total['bound'] / pool_total['device']:.1%})")
    summary = {"card": card, "bn": totals, "pool": pool_total}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeat", type=int, default=5,
                        help="measurements of the (175616, 256) BN call")
    main(parser.parse_args().repeat)
