#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``multimodal_clinical_tpu_torch``) on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the repository root.

Phases, each of which raises on failure:

1. device: CUDA is required; prints the card's name and power limit;
2. build: compiles every CUDA source of the port with nvcc for sm_90a, one
   nvcc per source, all at once;
3. kernels: the log-STFT kernel against its plain PyTorch version on the
   card, at the main path's shape and at a ragged one, with its times
   beside its bound and the library call that computes the same function,
   each one's share of the bound, and the operations the FFT executes;
4. switched towers: the two full-width bf16 towers with
   ``bn_fused=True, pool_kernel="pallas"``, forward and backward on the
   main path's preprocessed inputs.  A first pass records the shape of
   every BN-sums and max-pool call; it and a pass of the default towers
   are held against the same towers in fp32 (outputs and stem-conv
   gradients).  Then passes timed in turns against the default towers,
   and every BN-sums and max-pool kernel must have launched as often as
   the towers call it;
5. kernels: the BN-sums and max-pool kernels as in 3, at every shape
   phase 4 recorded, summed over a pass's calls, and at ragged shapes; two
   launches must agree bit for bit; the BN-sums forward's and the max-pool
   backward's device-only time per call (``torch.profiler``) beside the
   event-pair time; the stem's switched BN module against the default BN;
6. card against CPU: a narrow fp32 VGGSound step, two train steps from the
   same weights on the card and on the CPU, with the default and with the
   stored-index max-pool; a narrow encoder with both kernel switches on,
   forward and backward;
7. main path: the VGGSound jprobas train step at batch 224 (two ResNet18
   towers, bf16, 309 classes), one warm-up step, timed steps, one eval
   step; every kernel of the path must have launched;
8. switched main path: the same step with ``pool_kernel="pallas"``, whose
   stem max-pools are the stored-index kernels;
9. probes: the ported tool probes' ``main`` at the TPU probes' full
   geometries (``tools/proto_pallas_conv``: 8 conv geometries, the kernel
   against cuDNN; ``tools/proto_bn_stats``: 3 geometries, conv -> stats ->
   scale, shift, ReLU -> sum, the kernel's stats against the plain
   formula's; ``tools/probe_pallas_layout``: variants A, B and C of the
   visual stem's conv -> ReLU -> copy -> max-pool); each of the three
   kernels must have launched;
10. probe kernels: the conv, BN-stats and copy kernels against their plain
   versions at every geometry of phase 9 and at ragged shapes, timed beside
   their bound, plain version and library call, with each one's share of
   the bound (for the conv, each geometry's share of the bf16 peak beside
   cuDNN's);
11. CLI: ``python3 -m multimodal_clinical_tpu_torch --dir vggsound`` as a
   subprocess at the config's full geometry (batch 224, 309 classes, two
   width-64 ResNet18 towers in bf16) on the synthetic twin, two epochs;
   its printed summary, ``metrics.jsonl`` rows, committed checkpoint
   directory and ``meta.json`` are checked, then ``--resume`` with one more
   epoch, in process through the same entry point
   (``__main__.run_training``), must train exactly one more; a process
   that only imports the CLI and makes its CUDA context is timed first,
   and each subprocess logs when its first line, each epoch line and its
   summary came;
12. loop: ``engine.run.run_benchmark`` in process on a waveform dataset
   (896 train, 224 val and 224 test rows of 80 000 samples and four uint8
   frames) through the ``Loader`` with 4 gather threads, two epochs; the
   log-STFT kernel must launch once per train, val and test step, and the
   epoch-2 train steps' wall time is printed beside the fixture's step of
   phase 7, whose batch is already on the card;
13. contracts, card against CPU: a narrow Crema-D net (width 8, 257 x 40
   spectrograms from waveforms, one 32 x 32 frame) for two train steps,
   the second batch with a padded tail, from the same weights under
   jlogits, ensemble, ogm_ge (modes OGM and OGM_GE, the same noise
   tensors on both), qmf and ogm_ge_lreg: in fp32 (TF32 off) the losses,
   BN buffers, EMA and QMF tables, in float64 the parameter updates and
   momentum buffers too; the tables written at the batches' real idx only;
14. Crema-D and AVE at the published geometry, nothing cut (two width-64
   ResNet18 towers in bf16, batch 64, 160 000-sample waveforms through
   ``cremad_spectrogram`` to (257, 1004), 3 or 6 uint8 frames of 224 x
   224): each of Crema-D's ten and AVE's three model types through its
   benchmark's spec and device preprocess, one warm-up step (a padded
   tail, after which the QMF History must have changed at the batch's
   real idx and nowhere else), timed steps and one eval step, with step
   ms, samples/s and peak GiB; one Crema-D ogm_ge run with
   ``pool_kernel="pallas"``, whose max-pool launches are asserted and
   whose max-pool calls are recorded, each kernel then held against its
   plain version exactly at every shape recorded there; then
   VGGSound's jlogits and ensemble at batch 224 from waveforms, the
   log-STFT launches asserted;
15. contracts CLI: ``--dir cremad --set model_type=qmf`` at full width on
   the synthetic twin, two epochs, then ``--resume`` for a third, whose
   restored History tables must equal the saved ones; then ``--dir ave``
   for one epoch; all in process through ``__main__.run_training``, the
   entry point of ``python3 -m`` (phase 11 runs it as a subprocess);
16. the disk feed: corpora in the reference's layouts at the published
   per-sample geometry, clip counts cut (``benchmarks/disk_fixture.py``:
   VGGSound 448 + 224 clips of a 10 s wav and 10 JPEGs of 640 x 360;
   Crema-D 128 + 64 clips with pickles, and again with wavs; AVE 128 + 64 +
   64 clips with pickles), and which host decoders load; VGGSound jprobas
   through ``get_data`` on its corpus at batch 224, two epochs of two
   steps: the first batch on the card against its gather bit for bit, the
   Loader alone, the epoch-2 step through it, the log-STFT's launches and
   the kernel against its plain version on the disk waveforms; the CLI on
   the corpus and ``--resume``; the Crema-D qmf CLI on the pickles and
   ``--resume``, Crema-D ogm_ge on the wavs with ``pool_kernel="pallas"``
   (both max-pool kernels counted), the AVE CLI on its pickles; stream
   mode's spectrograms on the card against the CPU-made pickles;
17. AV-MNIST, MIMIC and MUsTARD: (a) AV-MNIST jlogits (plain SGD), MIMIC
   jprobas (Adam, at 1e-2 and at the config's 0.1) and jlogits (SGD with
   momentum) and MUsTARD jlogits (Adam, three towers) for two train steps
   on the card and on the CPU from the same weights, the second batch with
   a padded tail: losses, BN buffers and EMA in fp32, updates and
   optimizer state in float64 (under Adam, the updates where both devices'
   gradient entries agree; at 0.1 the second loss to a looser limit,
   beside its witness, the CPU against itself with the classes permuted);
   then, at the settings a process starts with (cuDNN TF32 on, every CPU
   thread), per benchmark, its launch counts set to 0 first and read last:
   (b) every model type at the published geometry (batch 32; 28 x 28 and
   112 x 112; 5 and 24 x 12; 40 x {371, 81, 300} in fp32), a warm-up step,
   timed steps, an eval step and one profiled step (the device's busy time
   in it, and its idle share of the median step); (c) the CLI on
   the twin for two epochs (``python3 -m multimodal_clinical_tpu_torch
   --dir mustard`` as a subprocess; AV-MNIST's and MIMIC's
   ``__main__.run_training`` in process), ``--resume`` for a third in
   process (the restored optimizer state, EMA and QMF tables equal the
   saved ones), every other model type for one epoch in process; (d) the
   files of
   ``benchmarks/array_fixture.py`` (AV-MNIST's six ``.npy`` at 55 320 + 320
   rows, MIMIC's ``im.pk``, MUsTARD's ``sarcasm.pkl``) through ``get_data``
   for one CLI epoch.  No TPU kernel lies on these paths: each must record 0
   launches;
18. Enrico and FakeNews: (a) narrow nets on the card against the CPU, two
   train steps from the same weights, the second batch with a padded tail:
   Enrico jlogits (frozen ResNet18Slim features at width 16) and
   jlogits_counts (frozen VGG11Slim stacks, their 16 dropouts' masks
   drawn on the CPU for both devices), FakeNews jlogits_dialogue (two
   256-wide text towers over rows with padded tails and one of padding
   only, a width-16 image tower) and jlogits_embed (one Bottleneck block a
   stage, its fusion dropout injected): losses, BN buffers and EMA in fp32,
   updates and optimizer state in float64, the frozen leaves bit-unchanged
   with no optimizer state; then at a fresh process's settings, the launch
   counts set to 0 first and read last: (b) all five Enrico and six
   FakeNews model types at the published geometry (Enrico batch 64 of
   256 x 128 uint8 screenshots and wireframes, 20 topics; FakeNews batch
   32 of 128 tokens over a 30 522 vocabulary and 224 x 224 images, the
   embed variants 768-d embeddings and ResNet152), a warm-up step, timed
   steps, an eval step and one profiled step, the frozen leaves
   bit-identical after; ``load_pretrained`` from seeded torchvision-layout
   resnet18 and resnet152 files against the same weights loaded directly;
   (c) both CLIs on their twins for two epochs and ``--resume`` for a
   third, then on disk corpora (Enrico 128 screens of 1440 x 2560;
   FakeNews 96 + 32 + 32 posts with 640 x 480 images, the token variant
   and the embed dialogue variant) for one epoch.  No TPU kernel lies on
   these paths: each must record 0 launches;
19. Food101's SigLIP family: (a) the narrow net (the tiny SigLIP of
   ``tests/test_siglip_parity.py``: width 64, 2 blocks, 32 x 32 images,
   16 tokens) under jlogits, ensemble, ogm_ge and qmf on the card against
   the CPU, two train steps from the same weights and dropout masks, the
   second batch with a padded tail, TF32 off: losses, EMA and QMF tables
   in fp32, updates and momentum in float64; then at a fresh process's
   settings, the launch counts set to 0 first and read last: (b) each type
   at the published geometry (siglip-base-patch16-224 in bf16, batch 128
   of the twin's 64 ids and 224 x 224 pixels, 101 classes), a warm-up step
   with a padded tail (the History changed at the real idx only; under
   ogm_ge every gradient bit-unchanged by the modulation), timed steps, an
   eval step and one profiled step; (e) a seeded siglip-base
   ``model.safetensors`` through ``load_pretrained`` and the towers'
   fp32 forward on the card against the CPU; (c) the CLI's ``--dir
   food101`` (qmf) in process on the twin for two epochs, ``--resume`` for
   a third (the History, momentum and EMA restored as saved), the other
   three types for one epoch each; (d)
   ``benchmarks/disk_fixture.py::build_food101_tree`` files (256 + 32 +
   32 samples at the published geometry) through ``get_data``, the first
   batch on the card against its gather, one CLI epoch.  No TPU kernel
   lies on this path: each must record 0 launches;
20. Food101's legacy pair (a frozen torchvision ResNet50 and a frozen
   bert-base with trainable heads): (a) the narrow net (a two-stage
   ResNet, two 32-wide BERT layers, 32 x 32 images, 16 ids) under jprobas
   and jprobas_jlogits on the card against the CPU, two train steps from
   the same weights and dropout masks (BERT's seven a step, the attention
   weights' included), TF32 off: losses, BN buffers and EMA in fp32,
   the heads' updates and momentum in float64, the frozen leaves
   bit-unchanged with no optimizer state; then at a fresh process's
   settings, the launch counts set to 0 first and read last: (b) each type
   at the published geometry (resnet50 and bert-base in bf16, batch 128
   of 224 x 224 x 3 images and 512 ids, 101 classes), two steps (the
   first with a padded tail) after which every frozen parameter is
   bit-unchanged and every BN running statistic has moved, timed steps,
   an eval step and one profiled step; (c) a seeded torchvision-named
   resnet50 ``.pth`` and an HF-named bert-base ``model.safetensors``
   through ``load_pretrained``, and the towers' fp32 forward on the card
   against the CPU; (d) ``benchmarks/disk_fixture.py::
   build_food101_legacy_tree`` files (256 + 64 samples, JPEGs of 512 x
   384) through ``get_data``, the first batch on the card against its
   gather, ``python3 -m multimodal_clinical_tpu_torch --dir food101 --set
   model_type=jprobas_jlogits`` on them for two epochs, ``--resume`` for a
   third in process, jprobas for one epoch.  No TPU kernel lies on this
   path: each must record 0 launches;
21. the multi-seed sweep (``engine/multiseed.py``), vmap's per-sample
   fallback warning an error throughout: (a) S = 3 seeds for two train
   steps in fp32 (TF32 off) on per-seed data, the card's sweep against
   the same sweep on the CPU and against three single-seed runs on the
   card: losses, BN buffers, EMA and QMF tables; Crema-D's narrow net with
   the stored-index pool under every contract, with and without the
   BN-sums BN, MIMIC's nets under SGD and Adam, dropout heads on MIMIC's
   inputs; each kernel launches once a call for the three seeds (a single
   run's count for one seed), and the max-pool and BN-sums kernels are
   held against their plain versions at the folded shapes; then at a
   fresh process's settings, the launch counts set to 0 first and read
   last: (b) at the config's geometry, two epochs on the twins: through
   the CLI in process, MIMIC jlogits and ensemble with 20 seeds and
   AV-MNIST jlogits with 8; through the CLI's ``run_multiseed`` with a
   substituted benchmark module, Crema-D ogm_ge with 4 and the
   stored-index pool (two launches of each max-pool kernel a step for all
   seeds, both kernels then held against their plain versions at the
   shapes that run recorded), and VGGSound jprobas with 2 on phase 12's
   waveform rows (one log-STFT launch a train and an eval step for both
   seeds, the kernel then held against its plain version on the folded
   rows); (c) per sweep, the
   step's median, the step per seed, the device's idle share and peak
   memory beside the single-seed step that phases 7, 14 and 17b measured,
   and ``seeds.csv`` read back;
22. the tower switches and the tools: (a) narrow fp32 steps of the
   fixture under ``remat="none"`` and under ``"convs"`` with the
   space-to-depth stem, card against CPU, and the narrow switched encoder
   under ``"convs"`` (20 BN-sums launches forward and 19 more in the
   recompute); then the fixture at batch 224 (309 classes, bf16, the
   stored-index pool) from one state with the stem plain and
   space-to-depth and ``remat`` None, "convs" and "none", the plain run
   again last as the witness: step ms, peak GiB, a profiled step's idle
   share, launches; after three steps each remat run's losses and running
   buffers against the plain run's, within a multiple of the witness's
   gap; the conv outputs the "convs" policy saved; both max-pool kernels
   against their plain versions at the path's shapes; (b) the resnet50
   Bottleneck tower with ``bn_fused=True`` trained at batch 32 of 224 x
   224 in bf16 (53 BN-sums launches each way a step), both BN-sums
   kernels then held at every shape it gave them, C = 2048 included; (c)
   a full-width VGGSound jprobas run for one epoch on waveform rows,
   ``tools/predict.py`` on its best checkpoint (the trainer's test
   accuracy, one log-STFT launch an eval batch), ``tools/export.py
   --batch sym`` and the loaded artifact on one test batch of 224 (the
   log-STFT launched inside the served program; within SERVE_TOL of the
   eval step's outputs); (d) ``tools/preprocess.py cremad-audio`` on the
   card against the CPU.

The CLI runs as a ``python3 -m`` subprocess once per family (phase 11 for
VGGSound, Crema-D and AVE, 17c for the small nets, 20d for Food101), and
elsewhere in process through ``__main__.run_training``, the function that
``python3 -m`` calls.

Each path's launch counts are set to 0 just before it is driven and read
just after; launches made to compare or time a kernel do not count.  The
kernels' line gives each kernel's launches on the main path as
``launches`` and on the later paths under ``launches_by_path`` (0 on
AV-MNIST's, MIMIC's, MUsTARD's, Enrico's, FakeNews's, Food101's and the
Food101 legacy pair's; ``multiseed`` for phase 21b's sweeps and
``multiseed_narrow`` for 21a's card sweeps; ``remat``,
``bottleneck_bn_fused`` and ``serve`` for phase 22a-c); the
max-pool's entries list the shapes checked on the phase 14 path and on
phase 21b's Crema-D sweep (``multiseed``) and on phase 22a's fixture
(``remat``) under ``checked_shapes_by_path``.

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits 2 and prints no
result.  Imports nothing of JAX.
"""

from __future__ import annotations

import ast
import collections
import contextlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_clinical_tpu_torch.benchmarks.switched_kernels import (
    card_line, cuda_ms, device_ms,
)

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
# BN sums, kernel against plain version: fp32 sums of the same terms in
# another order (per-thread runs of up to a few hundred rows, then
# fixed-order trees, against PyTorch's reduction); each channel is held to
# 1e-5 of the sum of its terms' magnitudes.  The max-pool kernels must
# equal their plain versions exactly: the max is one of its inputs, and dx
# is the same fp32 sum in the same order, rounded once.
SUM_RTOL = 1e-5
# the narrow switched encoder, card against CPU, fp32 and TF32 off, from
# seed 0: on the CPU alone its fp32 gradients agree with float64 to 5e-6
# of each tensor's largest entry and its loss to 3e-7, so no ReLU or
# max-pool decision sits within fp32 rounding of its threshold
ENC_SEED, ENC_INPUT = 0, (4, 48, 48, 1)
ENC_LOSS_RTOL = 1e-4
ENC_GRAD_TOL = 1e-4
# the switched towers: timed passes in turns, after one warm-up pass each
TOWER_TIMED = 3
# the switched and the default bf16 towers, full width, one pass from the
# same weights and inputs, each held against the same towers in fp32 (TF32
# off): outputs and stem-conv weight gradients, each tensor's largest
# difference in units of its largest entry.  Both bf16 paths round every
# op's result once, so the switched towers may stray from fp32 at most
# TOWER_RATIO times as far as the default towers do.  (The two bf16 paths
# alone part by 2.4e-1 in the stem-conv gradient on the H100: ReLU and
# max-pool decisions within bf16 rounding of their thresholds flip.)
TOWER_RATIO = 2.0
# the switched BN module against the default one at the stem, bf16: both
# compute y and dx in fp32 from the same sums (to ~1e-6) and round once, so
# they differ by at most one bf16 ulp of an entry, under 2^-7 of the
# largest entry; twice that is the limit
BN_MODULE_TOL = 2.0 ** -6
# the tool probes' kernels against their plain versions (phase 10).  Copy:
# bit-equal.  One-pass BN stats: fp32 sums of the same terms in another
# order, mean within 1e-5 of the channel's mean |x|, var within 2e-5 of its
# mean x^2, two launches bit-equal.  Conv: both sides sum exact bf16
# products in fp32 in another order and round once, so an entry differs by
# at most one bf16 ulp (2^-7 of the larger of the two) where the two fp32
# sums straddle a rounding boundary; near 0 the fp32 sums' own difference
# is larger than that ulp: at K = 9 * 512 it passed 1e-6 of the largest
# entry on the H100 (the tensor cores' fp32 sums against cuBLAS's), so the
# absolute term is 1e-5 of the largest entry.  A wrong tap, fragment or halo
# shows at the entries' own scale, 1e5 times that.
STATS_MEAN_TOL, STATS_VAR_TOL = 1e-5, 2e-5
CONV_ULP_RTOL, CONV_ULP_ATOL = 2.0 ** -7, 1e-5
# H100 SXM bf16 dense tensor-core peak (NVIDIA data sheet, 700 W)
PEAK_BF16_FLOPS = 989e12
# timed calls per variant in the probes' mains
PROBE_ITERS = 20
# the main path's towers: (batch, H, W, input channels)
AUDIO_TOWER = (BATCH, 129, 626, 1)
VISUAL_TOWER = (BATCH * 4, 224, 224, 3)


def log(msg: str) -> None:
    print(msg, flush=True)


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
    # what this kernel executes (log line only): per pair of frames the
    # window (2 n), the complex four-step FFT's (n / 2) log2 n butterflies
    # of 10 and its n twiddle products of 6; per frame and bin the split,
    # |X| and the log (9)
    kernel_flops = (b * -(-frames // 2) * (5 * n_fft * math.log2(n_fft)
                                          + 8 * n_fft)
                    + b * frames * (n_fft // 2 + 1) * 9)
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
        f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}), "
        f"{entry['bound_ms'] / ms * 100:.1f}% of it (torch.stft "
        f"{entry['bound_ms'] / library_ms * 100:.1f}%); the FFT design "
        f"executes {kernel_flops / 1e9:.3f} GFLOP, "
        f"{kernel_flops / PEAK_FP32_FLOPS * 1e3:.4f} ms at the fp32 peak")
    return [entry]


def _bound(bytes_moved: float, fp32_ops: float):
    bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = fp32_ops / PEAK_FP32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def _check_sums(got, want, magnitude, what: str):
    """(largest |kernel - plain|, largest |kernel - plain| / sum of the
    terms' magnitudes) over both sums; raises past SUM_RTOL."""
    worst, worst_rel = 0.0, 0.0
    for g, w, mag in zip(got, want, magnitude):
        err = (g - w).abs()
        rel = float((err / mag.clamp_min(1e-30)).max())
        if not rel <= SUM_RTOL:
            raise AssertionError(f"{what}: kernel and plain sums differ by "
                                 f"{rel:.3e} of the terms' magnitude")
        worst, worst_rel = max(worst, float(err.max())), max(worst_rel, rel)
    return worst, worst_rel


def _bn_case(m: int, c: int, dtype, seed: int):
    """A BN input (mean 0.5, unit spread, as a conv output), a gradient, and
    the batch statistics the train path would derive from the input."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, c, device="cuda", dtype=dtype, generator=gen).add_(0.5)
    dy = torch.randn(m, c, device="cuda", dtype=dtype, generator=gen)
    s, s2 = x.float().sum(0), x.float().square().sum(0)
    mean = s / m
    rstd = torch.rsqrt((s2 / m - mean * mean).clamp_min(0) + 1e-5)
    return x, dy, mean, rstd


def _check_bn(x, dy, mean, rstd, what: str):
    """Both BN-sums kernels against their plain versions, and a second
    launch against the first; returns each one's (absolute, relative)
    largest error."""
    from multimodal_clinical_tpu_torch.ops import cuda_fused_bn as cfb
    from multimodal_clinical_tpu_torch.ops import fused_bn

    fwd = cfb.launch_channel_sums(x)
    bwd = cfb.launch_bwd_sums(dy, x, mean, rstd)
    torch.cuda.synchronize()
    x32, dy32 = x.float(), dy.float()
    fwd_err = _check_sums(fwd, fused_bn.channel_sums(x),
                          (x32.abs().sum(0), x32.square().sum(0)),
                          f"bn_sums {what}")
    dy_xhat = dy32 * ((x32 - mean) * rstd)
    del x32
    bwd_err = _check_sums(bwd, fused_bn.bwd_sums(dy, x, mean, rstd),
                          (dy32.abs().sum(0), dy_xhat.abs().sum(0)),
                          f"bn_bwd_sums {what}")
    del dy32, dy_xhat
    again = cfb.launch_channel_sums(x) + cfb.launch_bwd_sums(dy, x, mean, rstd)
    if not all(torch.equal(a, b) for a, b in zip(fwd + bwd, again)):
        raise AssertionError(f"BN sums {what}: two launches differ")
    return fwd_err, bwd_err


def _check_pool(x, what: str):
    """Both max-pool kernels against their plain versions (exactly), and a
    second launch against the first; returns (y, idx, dy)."""
    from multimodal_clinical_tpu_torch.ops import cuda_maxpool as cmp
    from multimodal_clinical_tpu_torch.ops import maxpool

    h, w = x.shape[1:3]
    y, idx = cmp.launch_pool_fwd(x)
    torch.cuda.synchronize()
    want_y, want_idx = maxpool.pool_fwd(x)
    if not (torch.equal(y, want_y) and torch.equal(idx, want_idx)):
        raise AssertionError(f"maxpool_fwd {what}: kernel and plain differ")
    del want_y, want_idx
    gen = torch.Generator(device="cuda").manual_seed(1)
    dy = torch.randn(y.shape, device="cuda", dtype=x.dtype, generator=gen)
    dx = cmp.launch_pool_bwd(dy, idx, h, w)
    torch.cuda.synchronize()
    if not torch.equal(dx, maxpool.pool_bwd(dy, idx, h, w)):
        raise AssertionError(f"maxpool_bwd {what}: kernel and plain differ")
    y2, idx2 = cmp.launch_pool_fwd(x)
    if not (torch.equal(y, y2) and torch.equal(idx, idx2) and torch.equal(
            dx, cmp.launch_pool_bwd(dy, idx, h, w))):
        raise AssertionError(f"max-pool {what}: two launches differ")
    return y, idx, dy


def _check_bn_module(stem, device):
    """The switched BN module (``FusedBatchNorm``: the sums kernels and the
    eager apply and dx) against the default one (PyTorch's batch norm) in a
    train-mode forward and backward, from the same weights, on a bf16
    channels_last map of NHWC shape ``stem``: y and dx to BN_MODULE_TOL of
    the largest entry, the weight and bias gradients to SUM_RTOL of their
    terms' magnitude.  Returns the errors of y and dx, and the largest
    absolute and relative errors of the parameter gradients."""
    from multimodal_clinical_tpu_torch.models.common import (
        FusedBatchNorm, TorchBatchNorm,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    x, noise = (torch.randn(stem, device=device, dtype=torch.bfloat16,
                            generator=gen).permute(0, 3, 1, 2)
                for _ in range(2))
    x = x.add(0.5)  # a conv output's offset mean, still channels_last
    # a gradient with a mean and a part along x, as in a net: the terms of
    # dx that take them out are then as large as g * dy
    dy = noise.add(x, alpha=0.5)
    c = stem[-1]
    fused = FusedBatchNorm(c, torch.bfloat16).to(device)
    default = TorchBatchNorm(c, torch.bfloat16).to(device)
    default.load_state_dict(fused.state_dict())
    got = {}
    for name, module in (("default", default), ("fused", fused)):
        xi = x.detach().requires_grad_(True)
        y = module(xi)
        y.backward(dy)
        got[name] = (y.detach(), xi.grad, module.weight.grad,
                     module.bias.grad)
    del xi, y
    errs = [_scaled_err(a.float(), b.float())
            for a, b in zip(got["fused"][:2], got["default"][:2])]
    if not max(errs) <= BN_MODULE_TOL:
        raise AssertionError(f"BN module {stem}: y and dx differ from the "
                             f"default BN's by {errs} of the largest entry")
    x32, dy32 = x.float(), dy.float()
    mean = x32.mean((0, 2, 3), keepdim=True)
    rstd = torch.rsqrt(x32.var((0, 2, 3), unbiased=False, keepdim=True)
                       + fused.eps)
    magnitude = ((dy32 * (x32 - mean) * rstd).abs().sum((0, 2, 3)),
                 dy32.abs().sum((0, 2, 3)))
    del x32, dy32
    errs += _check_sums(got["fused"][2:], got["default"][2:], magnitude,
                        f"BN module {stem} weight and bias gradients")
    return errs


def phase_switched_kernels(device, calls, launches):
    """The BN-sums and stored-index max-pool kernels: each against its plain
    version at every shape that one pass of the switched towers gave it
    (``calls``, recorded in that pass; bf16), and at ragged shapes (bf16
    and fp32); times per call and summed over the pass's calls, beside the
    bound and the library call.  ``launches`` are the towers' BN-sums
    launch counts."""
    from multimodal_clinical_tpu_torch.ops import cuda_fused_bn as cfb
    from multimodal_clinical_tpu_torch.ops import cuda_maxpool as cmp
    from multimodal_clinical_tpu_torch.ops import fused_bn, maxpool

    names = ("bn_sums", "bn_bwd_sums", "maxpool_fwd", "maxpool_bwd")
    totals = {n: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, device_ms=0.0,
                      bytes=0.0, ops=0.0, calls=0, err=0.0, rel=0.0)
              for n in names}

    def add(name, count, ms, plain_ms, library_ms, bytes_moved, ops, err,
            device=0.0):
        t = totals[name]
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", library_ms), ("device_ms", device),
                       ("bytes", bytes_moved), ("ops", ops)):
            t[key] += count * v
        t["calls"] += count
        t["err"] = max(t["err"], err[0])
        t["rel"] = max(t["rel"], err[1])

    # ragged shapes first: M not a multiple of a block's rows, C not a
    # divisor of the block's threads, fp32 and bf16; one row; fewer rows
    # than the forward's grid has blocks, at the widest C
    for m, c, dtype in ((1_000_003, 64, torch.bfloat16),
                        (1003, 128, torch.float32),
                        (513, 24, torch.float32), (1, 8, torch.bfloat16),
                        (300, 2048, torch.bfloat16)):
        errs = _check_bn(*_bn_case(m, c, dtype, seed=m), f"({m}, {c}) {dtype}")
        log(f"[kernels] BN sums ({m}, {c}) {dtype}: max |err| forward "
            f"{errs[0][0]:.3e} ({errs[0][1]:.2e} of the terms' magnitude), "
            f"backward {errs[1][0]:.3e} ({errs[1][1]:.2e})")
    # the backward's tiles: odd and even H and W, a single window row and
    # column, C = 24 (one channel vector per tile), column tiles that do
    # not divide the map
    for shape in ((3, 9, 11, 64), (2, 2, 1, 24), (2, 65, 70, 256)):
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device="cuda").manual_seed(2)
            x = torch.randn(shape, device="cuda", generator=gen)
            x = (x * 2).round().div(2).clamp_min(0).to(dtype)  # tie plateaus
            _check_pool(x, f"{shape} {dtype}")
        log(f"[kernels] max-pool {shape} bf16 and fp32 with tie plateaus: "
            f"equal to the plain version")

    bn_calls = collections.Counter(calls["bn_sums"])
    for (m, c), count in sorted(bn_calls.items(), key=lambda kv: -kv[0][0]):
        x, dy, mean, rstd = _bn_case(m, c, torch.bfloat16, seed=m)
        errs = _check_bn(x, dy, mean, rstd, f"({m}, {c})")
        weight = torch.ones(c, device=device)
        fwd = (cuda_ms(lambda: cfb.launch_channel_sums(x)),
               cuda_ms(lambda: fused_bn.channel_sums(x)),
               cuda_ms(lambda: torch.batch_norm_stats(x, 1e-5)))
        bwd = (cuda_ms(lambda: cfb.launch_bwd_sums(dy, x, mean, rstd)),
               cuda_ms(lambda: fused_bn.bwd_sums(dy, x, mean, rstd)),
               cuda_ms(lambda: torch.batch_norm_backward_reduce(
                   dy, x, mean, rstd, weight, True, True, True)))
        # the forward's device-only time (profiler) beside the event pair,
        # which counts the host where a call's host time exceeds the card's
        fwd_device = device_ms(lambda: cfb.launch_channel_sums(x))[0]
        n = m * c
        add("bn_sums", count, *fwd, 2 * n + 8 * c, 3 * n, errs[0], fwd_device)
        add("bn_bwd_sums", count, *bwd, 4 * n + 16 * c, 6 * n, errs[1])
        log(f"[kernels] BN sums ({m}, {c}) bf16, {count} per pass: forward "
            f"{fwd[0]:.4f} ms (device-only {fwd_device:.4f}, plain "
            f"{fwd[1]:.4f}, batch_norm_stats "
            f"{fwd[2]:.4f}, bound {_bound(2 * n, 3 * n)[0]:.4f}), backward "
            f"{bwd[0]:.4f} ms (plain {bwd[1]:.4f}, batch_norm_backward_reduce "
            f"{bwd[2]:.4f}, bound {_bound(4 * n, 6 * n)[0]:.4f}); max |err| "
            f"{errs[0][0]:.3e} / {errs[1][0]:.3e}, of the terms' magnitude "
            f"{errs[0][1]:.2e} / {errs[1][1]:.2e}")
        del x, dy
    pool_calls = collections.Counter(calls["maxpool_fwd"])
    for stem, count in sorted(pool_calls.items(), key=lambda kv: -kv[0][0]):
        gen = torch.Generator(device="cuda").manual_seed(3)
        # a post-ReLU stem map: half its entries are tied at zero
        x = torch.randn(stem, device="cuda", dtype=torch.bfloat16,
                        generator=gen).clamp_min_(0)
        y, idx, dy = _check_pool(x, str(stem))
        h, w = stem[1:3]
        x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        _, lib_idx = F.max_pool2d(x_nchw, 3, 2, 1, return_indices=True)
        fwd = (cuda_ms(lambda: cmp.launch_pool_fwd(x)),
               cuda_ms(lambda: maxpool.pool_fwd(x)),
               cuda_ms(lambda: F.max_pool2d(x_nchw, 3, 2, 1,
                                            return_indices=True)))
        bwd = (cuda_ms(lambda: cmp.launch_pool_bwd(dy, idx, h, w)),
               cuda_ms(lambda: maxpool.pool_bwd(dy, idx, h, w)),
               cuda_ms(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                   dy_nchw, x_nchw, [3, 3], [2, 2], [1, 1], [1, 1], False,
                   lib_idx)))
        bwd_device = device_ms(lambda: cmp.launch_pool_bwd(dy, idx, h, w))[0]
        n_in, n_out = x.numel(), y.numel()
        # bf16 in, bf16 y and uint8 index out; 8 compares per output
        add("maxpool_fwd", count, *fwd, 2 * n_in + 3 * n_out, 8 * n_out,
            (0.0, 0.0))
        # bf16 dy and uint8 index in, bf16 dx out; an add per routed dy
        add("maxpool_bwd", count, *bwd, 3 * n_out + 2 * n_in, n_out,
            (0.0, 0.0), bwd_device)
        log(f"[kernels] max-pool {stem} bf16 (post-ReLU, ties at 0), {count} "
            f"per pass: forward "
            f"{fwd[0]:.4f} ms (plain {fwd[1]:.4f}, max_pool2d with indices "
            f"{fwd[2]:.4f}, bound "
            f"{_bound(2 * n_in + 3 * n_out, 8 * n_out)[0]:.4f}), backward "
            f"{bwd[0]:.4f} ms (device-only {bwd_device:.4f}, plain "
            f"{bwd[1]:.4f}, "
            f"max_pool2d_with_indices_backward {bwd[2]:.4f}, bound "
            f"{_bound(3 * n_out + 2 * n_in, n_out)[0]:.4f}); equal to plain")
        del x, y, idx, dy, x_nchw, dy_nchw, lib_idx
    # the composed BN op at the largest map: the stem's (its BN input is
    # the map its max-pool takes)
    stem = max(pool_calls, key=math.prod)
    errs = _check_bn_module(stem, device)
    log(f"[kernels] BN module {stem} bf16, bn_fused against the default BN: "
        f"y within {errs[0]:.3e} and dx within {errs[1]:.3e} of the largest "
        f"entry; weight and bias gradients within {errs[3]:.2e} of their "
        f"terms' magnitude")
    torch.cuda.empty_cache()

    sources = {
        "bn_sums": ("bn_sums.cu", "fused_bn.py:104 _channel_sums_pallas"),
        "bn_bwd_sums": ("bn_sums.cu", "fused_bn.py:155 _bwd_sums_pallas"),
        "maxpool_fwd": ("maxpool.cu", "maxpool_pallas.py:128 _pool_fwd_pallas"),
        "maxpool_bwd": ("maxpool.cu", "maxpool_pallas.py:219 _pool_bwd_pallas"),
    }
    entries = []
    for name in names:
        t = totals[name]
        bound_ms, bound_by = _bound(t["bytes"], t["ops"])
        src, replaces = sources[name]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"multimodal_clinical_tpu_torch/csrc/{src}",
            "replaces": f"multimodal_clinical_tpu/ops/{replaces}",
            # the towers' BN launches; the pool's come from the main path
            "launches": launches.get(name),
            "max_abs_err": t["err"],
            # the same, over the sum of the terms' magnitudes (BN sums)
            "max_rel_err": t["rel"],
            # calls recorded in one pass of the switched towers (a train
            # step's); every time is the sum over them
            "calls_per_step": t["calls"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": t["library_ms"],
        })
        device = ""
        if t["device_ms"]:
            # the profiler's device-only time of the same calls, summed
            entries[-1]["device_ms"] = t["device_ms"]
            device = (f" (device-only {t['device_ms']:.4f} ms, "
                      f"{bound_ms / t['device_ms'] * 100:.1f}% of the bound)")
        log(f"[kernels] {name}, {t['calls']} calls per towers pass: "
            f"{t['ms']:.4f} ms{device}, plain {t['plain_ms']:.4f} ms, library "
            f"{t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return entries


def _scaled_err(got, want):
    """Largest difference, in units of ``want``'s largest entry."""
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def _narrow_step(dev, dtype, preprocess=None, pool_kernel="xla", **knobs):
    """Two train steps of the narrow fixture on ``dev`` (``knobs``: its
    ``remat`` and ``stem_space_to_depth``): losses, the initial and final
    state_dict, momentum buffers and EMA, on the CPU."""
    from multimodal_clinical_tpu_torch.benchmarks.vggsound_fixture import (
        build_vggsound_bench,
    )

    step, state, batch, spec = build_vggsound_bench(
        batch=2, num_classes=5, pool_kernel=pool_kernel, device=dev,
        frames_bf16=False, num_frames=2, image_size=32, samples=4000,
        width=8, dtype=None, **knobs)
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


def _compare_fp32_steps(card, host, what: str) -> None:
    """Losses, BN buffers and EMA of two fp32 narrow runs: the quantities
    that are continuous in the inputs."""
    np.testing.assert_allclose(card["losses"], host["losses"],
                               rtol=CPU_LOSS_RTOL)
    worst = 0.0
    for key, want in host["final"].items():
        assert torch.equal(card["init"][key], host["init"][key]), key
        if "running" in key:
            np.testing.assert_allclose(card["final"][key].numpy(),
                                       want.numpy(), rtol=CPU_BUFFER_RTOL,
                                       atol=CPU_BUFFER_ATOL, err_msg=key)
            worst = max(worst, _scaled_err(card["final"][key], want))
    np.testing.assert_allclose(card["ema"].numpy(), host["ema"].numpy(),
                               rtol=0, atol=CPU_EMA_ATOL)
    log(f"[card-vs-cpu] fp32 {what}: losses card {card['losses']} cpu "
        f"{host['losses']}; BN buffers within {worst:.2e}")


def _narrow_encoder(dev, remat=None):
    """One train-mode pass of a narrow ResNet18 with both kernel switches on
    ``dev``, fp32, under ``remat``: loss, gradients (the input's too),
    running buffers and the kernels' launches, on the CPU."""
    from multimodal_clinical_tpu_torch.models.common import init_weights
    from multimodal_clinical_tpu_torch.models.resnet import ResNetEncoder

    enc = ResNetEncoder(1, width=8, bn_fused=True, pool_kernel="pallas",
                        remat=remat)
    init_weights(enc, torch.Generator().manual_seed(ENC_SEED))
    enc = enc.to(dev, memory_format=torch.channels_last)
    rng = np.random.default_rng(ENC_SEED)
    x = torch.from_numpy(rng.normal(size=ENC_INPUT).astype(np.float32)).to(
        dev).requires_grad_(True)
    launchers = _switch_launchers()
    for fn in launchers.values():
        fn.launches = 0
    out = enc(x)
    w = torch.from_numpy(rng.normal(size=tuple(out.shape)).astype(
        np.float32)).to(dev)
    loss = (out * w).sum()
    loss.backward()
    cpu = lambda t: t.detach().cpu().clone()
    grads = {k: cpu(p.grad) for k, p in enc.named_parameters()}
    grads["input"] = cpu(x.grad)
    return dict(loss=float(loss.detach()), grads=grads,
                buffers={k: cpu(v) for k, v in enc.state_dict().items()
                         if "running" in k},
                launches={n: fn.launches for n, fn in launchers.items()})


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
    # the CPU side runs on 2 threads: PyTorch's CPU convolution backward
    # crashed at some small channels_last shapes on 4 threads
    torch.set_num_threads(2)
    cpu = torch.device("cpu")
    for pool_kernel in ("xla", "pallas"):
        _compare_fp32_steps(_narrow_step(device, torch.float32,
                                         pool_kernel=pool_kernel),
                            _narrow_step(cpu, torch.float32,
                                         pool_kernel=pool_kernel),
                            f"pool_kernel={pool_kernel!r}")

    def shared(batch, generator, train):
        out = vggsound.device_preprocess(
            {k: v.to(device) for k, v in batch.items()}, generator, train)
        dev = batch["label"].device
        return {k: (v.double() if k in ("x1", "x2") else v).to(dev)
                for k, v in out.items()}

    worst = {"update": 0.0, "momentum": 0.0}
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

    # one tower: 20 BNs and one stem max-pool, each forward and backward
    _compare_narrow_encoders(
        _narrow_encoder(device), _narrow_encoder(cpu),
        {"bn_sums": 20, "bn_bwd_sums": 20, "maxpool_fwd": 1,
         "maxpool_bwd": 1}, "")


def _compare_narrow_encoders(card, host, want, what: str) -> None:
    """The narrow switched encoder's pass on the card against the CPU's;
    the card must have launched each kernel as ``want`` says."""
    if card["launches"] != want or any(host["launches"].values()):
        raise AssertionError(f"narrow encoder{what} launches: card "
                             f"{card['launches']}, CPU {host['launches']}")
    np.testing.assert_allclose(card["loss"], host["loss"],
                               rtol=ENC_LOSS_RTOL)
    for key, ref in host["buffers"].items():
        np.testing.assert_allclose(card["buffers"][key].numpy(), ref.numpy(),
                                   rtol=CPU_BUFFER_RTOL,
                                   atol=CPU_BUFFER_ATOL, err_msg=key)
    grad_err = 0.0
    for key, ref in host["grads"].items():
        err = _scaled_err(card["grads"][key], ref)
        if not err <= ENC_GRAD_TOL:
            raise AssertionError(f"narrow encoder {key} gradient: card and "
                                 f"CPU differ by {err:.3e} of its largest "
                                 f"entry")
        grad_err = max(grad_err, err)
    buffer_err = max(_scaled_err(card["buffers"][k], v)
                     for k, v in host["buffers"].items())
    log(f"[card-vs-cpu] fp32 narrow encoder (bn_fused, pool_kernel="
        f"'pallas'{what}), input {ENC_INPUT}: loss card {card['loss']:.7g} "
        f"cpu {host['loss']:.7g}; gradients within {grad_err:.2e}, running "
        f"buffers (unbiased variance) within {buffer_err:.2e} of each "
        f"tensor's largest entry; card launches {card['launches']}")


def _switch_launchers():
    """The wrappers of the kernels behind ``bn_fused`` and ``pool_kernel``."""
    from multimodal_clinical_tpu_torch.ops import cuda_fused_bn as cfb
    from multimodal_clinical_tpu_torch.ops import cuda_maxpool as cmp

    return {"bn_sums": cfb.launch_channel_sums,
            "bn_bwd_sums": cfb.launch_bwd_sums,
            "maxpool_fwd": cmp.launch_pool_fwd,
            "maxpool_bwd": cmp.launch_pool_bwd}


def _all_launchers():
    from multimodal_clinical_tpu_torch.ops import cuda_spectrogram as cs

    return {"log_spectrogram": cs.launch_log_spectrogram,
            **_switch_launchers()}


@contextlib.contextmanager
def _recording_calls():
    """While open, every call of a switch's wrapper appends the shape it
    was given to ``calls[name]``: (M, C) of the BN sums' (..., C) input,
    the NHWC input map (B, H, W, C) of the max-pool, forward and backward.
    The wrappers are wrapped in their modules, where the ops look them up,
    and restored on exit."""
    from multimodal_clinical_tpu_torch.ops import cuda_fused_bn as cfb
    from multimodal_clinical_tpu_torch.ops import cuda_maxpool as cmp

    def bn_shape(x):
        return x.numel() // x.shape[-1], x.shape[-1]

    shape_of = {
        "bn_sums": (cfb, "launch_channel_sums", bn_shape),
        "bn_bwd_sums": (cfb, "launch_bwd_sums",
                        lambda dy, x, mean, rstd: bn_shape(x)),
        "maxpool_fwd": (cmp, "launch_pool_fwd", lambda x: tuple(x.shape)),
        "maxpool_bwd": (cmp, "launch_pool_bwd", lambda dy, idx, h, w: (
            dy.shape[0], h, w, dy.shape[3])),
    }
    calls = {name: [] for name in shape_of}

    def recording(name, fn, shape):
        def wrapper(*args):
            calls[name].append(shape(*args))
            return fn(*args)
        # the wrapped function counts its launch on the name its module
        # binds, which is this wrapper while recording
        wrapper.launches = 0
        return wrapper

    originals = {name: getattr(module, attr)
                 for name, (module, attr, _) in shape_of.items()}
    try:
        for name, (module, attr, shape) in shape_of.items():
            setattr(module, attr, recording(name, originals[name], shape))
        yield calls
    finally:
        for name, (module, attr, _) in shape_of.items():
            setattr(module, attr, originals[name])


def _drive_vggsound(device, card: str, pool_kernel: str, expected):
    """Warm-up, timed and eval steps of the VGGSound fixture at batch 224;
    raises unless every kernel in ``expected`` launched exactly so often.
    Returns (median step ms, launches)."""
    from multimodal_clinical_tpu_torch.benchmarks.vggsound_fixture import (
        build_vggsound_bench,
    )
    from multimodal_clinical_tpu_torch.engine.steps import make_eval_step

    launchers = _all_launchers()
    tag = f"[main pool_kernel={pool_kernel!r}]"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_step, state, batch, spec = build_vggsound_bench(
        BATCH, CLASSES, pool_kernel=pool_kernel, device=device)
    eval_step = make_eval_step(spec)
    torch.cuda.synchronize()
    log(f"{tag} fixture built in {time.perf_counter() - t0:.1f} s")
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
        log(f"{tag} step {i} {'warm-up' if i < WARMUP_STEPS else 'timed'}: "
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
    for name, count in launches.items():
        if count != expected.get(name, 0):
            raise AssertionError(
                f"{tag} {name} launched {count} times, expected "
                f"{expected.get(name, 0)}: {launches}")
    median = statistics.median(step_ms)
    log(f"{tag} {card}: train step median {median:.2f} ms, mean "
        f"{statistics.mean(step_ms):.2f} ms over {TIMED_STEPS} steps "
        f"(each {', '.join(f'{m:.2f}' for m in step_ms)}); "
        f"{BATCH / median * 1e3:.1f} samples/s at batch {BATCH}; eval loss "
        f"{float(out['loss']):.5f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {launches}")
    del train_step, state, batch, spec, eval_step, out
    torch.cuda.empty_cache()
    return median, launches


def phase_main_path(device, card: str, kernels):
    train_steps = WARMUP_STEPS + TIMED_STEPS
    default_ms, launches = _drive_vggsound(
        device, card, "xla",
        {"log_spectrogram": train_steps + EVAL_STEPS})
    # the stem max-pools through the stored-index kernels: two per train
    # step (one per tower), none in eval (the op's no-grad primal)
    switched_ms, switched = _drive_vggsound(
        device, card, "pallas",
        {"log_spectrogram": train_steps + EVAL_STEPS,
         "maxpool_fwd": 2 * train_steps, "maxpool_bwd": 2 * train_steps})
    SINGLE_STEP_MS[("vggsound", "jprobas")] = default_ms
    log(f"[main] {card}: train step median, default {default_ms:.2f} ms, "
        f"pool_kernel='pallas' {switched_ms:.2f} ms")
    for entry in kernels:
        if entry["name"] == "log_spectrogram":
            entry["launches"] = launches["log_spectrogram"]
        elif entry["name"].startswith("maxpool"):
            entry["launches"] = switched[entry["name"]]
    return default_ms


# phases 11-12 and 15 write their runs here (gitignored), and remove them after
WORK_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"
RUN_NAME = "vggsound_cls309_jprobas_seeds"  # configs/vggsound.yaml group


def _cli(args, timeout: int = 600, bench: str = "vggsound",
         device=None) -> str:
    """``python3 -m multimodal_clinical_tpu_torch --dir <bench>`` with
    ``args`` from the repository root, unbuffered; raises unless it exits
    0.  Logs where its seconds went: to its first line of output (the
    interpreter, the imports, the CUDA context, the config and the data),
    to each ``[epoch`` line, to its summary, and from the summary to its
    exit.  With a ``device``, the same entry point in process instead
    (``__main__.run_training``, what ``python3 -m`` calls), at the settings
    a fresh process starts with: no interpreter, imports or CUDA context to
    pay for.  Returns its standard output."""
    t = time.perf_counter()
    if device is not None:
        from multimodal_clinical_tpu_torch import __main__ as cli

        out = io.StringIO()
        with _torch_set(*TORCH_DEFAULTS), contextlib.redirect_stdout(out):
            cli.run_training(["--dir", bench, *args], device=device)
        out = out.getvalue()
        tail = "\n".join(out.strip().splitlines()[-6:])
        log(f"[cli] --dir {bench} {' '.join(args)} in process: "
            f"{time.perf_counter() - t:.1f} s\n{tail}")
        return out
    cmd = [sys.executable, "-m", "multimodal_clinical_tpu_torch",
           "--dir", bench, *args]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=Path(__file__).resolve().parent,
        env={**os.environ, "PYTHONUNBUFFERED": "1"})
    err = []
    drain = threading.Thread(target=lambda: err.append(proc.stderr.read()),
                             daemon=True)
    drain.start()
    lines, marks = [], []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("[epoch"):
                marks.append((line[1:line.index("]")], time.perf_counter() - t))
            elif line.startswith("{"):
                marks.append(("summary", time.perf_counter() - t))
            elif len(lines) == 1:
                marks.append(("first line", time.perf_counter() - t))
        proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t)))
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    drain.join()
    wall = time.perf_counter() - t
    out = "".join(lines)
    tail = "\n".join(out.strip().splitlines()[-6:])
    log(f"[cli] {' '.join(cmd[1:])}: exit {proc.returncode} in {wall:.1f} s "
        f"(seconds since start: " + ", ".join(
            f"{name} {at:.1f}" for name, at in marks) + f", exit {wall:.1f})"
        f"\n{tail}")
    if proc.returncode != 0:
        raise AssertionError(f"the CLI failed:\n{''.join(err)[-4000:]}")
    return out


def _process_floor() -> float:
    """The wall seconds of a process that only starts the interpreter,
    imports the port's CLI and makes its CUDA context: what every CLI
    subprocess pays before its own work."""
    t = time.perf_counter()
    subprocess.run([sys.executable, "-c",
                    "import torch, multimodal_clinical_tpu_torch.__main__; "
                    "torch.zeros(1, device='cuda'); torch.cuda.synchronize()"],
                   check=True, timeout=300,
                   cwd=Path(__file__).resolve().parent)
    wall = time.perf_counter() - t
    log(f"[cli] a process that imports the CLI and makes its CUDA context: "
        f"{wall:.1f} s")
    return wall


def _epoch_rows(run_dir: Path):
    rows = [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    return [r for r in rows if "epoch" in r]


def phase_cli(device):
    """The port's CLI at the config's full geometry on the synthetic twin
    as a ``python3 -m`` subprocess, then ``--resume`` with one more epoch
    in process."""
    work = WORK_DIR / "cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    _process_floor()
    try:
        base = ["--set", f"ckpt_dir={work}", "--set", f"data_path={work}/none"]
        out = _cli(base + ["--set", "num_epochs=2"])
        summary = ast.literal_eval(out.strip().splitlines()[-1])
        if not math.isfinite(summary.get("test_epoch/test_avg_acc", math.nan)):
            raise AssertionError(f"no test_epoch/test_avg_acc: {summary}")
        run_dir, ckpt = work / RUN_NAME, work / RUN_NAME / "ckpt"
        rows = _epoch_rows(run_dir)
        train_val = [r for r in rows if r["epoch"] >= 0]
        test = [r for r in rows if r["epoch"] == -1]
        if ([r["epoch"] for r in train_val] != [0, 1] or not all(
                "train_epoch/train_avg_loss" in r
                and "val_epoch/val_avg_acc" in r for r in train_val)
                or len(test) != 1 or "test_epoch/test_avg_acc" not in test[0]):
            raise AssertionError(f"metrics.jsonl epoch rows: {rows}")
        names = sorted(os.listdir(ckpt))
        if (any(n.endswith(".pending") for n in names)
                or names != ["best", "last-1", "last-2", "meta.json"]
                or not all((ckpt / n / "state.pt").is_file()
                           for n in names if n != "meta.json")):
            raise AssertionError(f"checkpoint directory: {names}")
        meta = json.loads((ckpt / "meta.json").read_text())
        if meta["epochs_done"] != 2 or meta["meta_step"] != 2:
            raise AssertionError(f"meta.json after two epochs: {meta}")
        out = _cli(base + ["--set", "num_epochs=3", "--resume"],
                   device=device)
        if "[trainer] resumed from step 2" not in out:
            raise AssertionError("the resumed run did not start at step 2")
        meta = json.loads((ckpt / "meta.json").read_text())
        steps = [(r["epoch"], r["_step"]) for r in _epoch_rows(run_dir)
                 if r["epoch"] >= 0]
        if meta["epochs_done"] != 3 or steps != [(0, 1), (1, 2), (2, 3)]:
            raise AssertionError(f"--resume: meta {meta}, epoch rows "
                                 f"(epoch, step) {steps}")
        log(f"[cli] two epochs, then --resume trained one more: epoch rows "
            f"(epoch, step) {steps}; test_avg_acc "
            f"{summary['test_epoch/test_avg_acc']:.4f}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _waveform_bundle(n_train: int, n_eval: int):
    """The waveform layout of the JAX package's
    ``tests/test_benchmarks_e2e.py::test_vggsound_waveform_to_spectrogram_path``
    at the main path's geometry, from numpy's seed-0 generator."""
    from multimodal_clinical_tpu_torch.data.core import ArrayDataset
    from multimodal_clinical_tpu_torch.engine.run import DataBundle

    class WaveDataset(ArrayDataset):
        def gather(self, indices):
            out = super().gather(indices)
            out["x1_waveform"] = out.pop("x1")
            return out

    rng = np.random.default_rng(0)

    def make(n):
        wave = rng.normal(scale=0.1, size=(n, 80000)).astype(np.float32)
        frames = rng.integers(0, 256, size=(n, 4, 224, 224, 3),
                              dtype=np.uint8)
        return WaveDataset([wave, frames],
                           rng.integers(0, CLASSES, n).astype(np.int32))

    return DataBundle(make(n_train), make(n_eval), make(n_eval),
                      train_sampler="weighted", val_sampler="weighted")


def phase_loop(device, card: str, fixture_ms: float, kernels):
    """``run_benchmark`` on waveform batches through the Loader: the
    log-STFT kernel in the real loop.  Each train step is followed by a
    synchronise, so the interval between two steps' ends is the step's wall
    time through the loader, comparable with the fixture's step."""
    from multimodal_clinical_tpu_torch.benchmarks import vggsound
    from multimodal_clinical_tpu_torch.config import load_config
    from multimodal_clinical_tpu_torch.engine import run
    from multimodal_clinical_tpu_torch.ops import cuda_spectrogram as cs

    epochs, workers = 2, 4
    work = WORK_DIR / "loop"
    shutil.rmtree(work, ignore_errors=True)
    t = time.perf_counter()
    bundle = _waveform_bundle(4 * BATCH, BATCH)
    log(f"[loop] waveform data ({len(bundle.train)} + {len(bundle.val)} + "
        f"{len(bundle.test)} rows) made in {time.perf_counter() - t:.1f} s")
    args = load_config("vggsound", overrides=dict(
        num_epochs=epochs, loader_workers=workers, ckpt_dir=str(work),
        data_path=str(work / "none")))
    module = SimpleNamespace(get_data=lambda _: bundle,
                             get_model_spec=vggsound.get_model_spec)
    ends, seen = [], {}

    class TimedTrainer(run.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["trainer"] = self
            step = self.train_step

            def timed(state, batch):
                state, metrics = step(state, batch)
                torch.cuda.synchronize()
                ends.append((self.train_loader._epoch, time.perf_counter()))
                return state, metrics

            self.train_step = timed

    trainer_cls, run.Trainer = run.Trainer, TimedTrainer
    cs.launch_log_spectrogram.launches = 0
    try:
        t = time.perf_counter()
        summary = run.run_benchmark(args, module, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        run.Trainer = trainer_cls
        shutil.rmtree(work, ignore_errors=True)
    launches = cs.launch_log_spectrogram.launches
    trainer = seen["trainer"]
    steps = {split: len(getattr(trainer, f"{split}_loader"))
             for split in ("train", "val", "test")}
    expected = epochs * (steps["train"] + steps["val"]) + steps["test"]
    if launches != expected:
        raise AssertionError(
            f"[loop] log_spectrogram launched {launches} times, expected "
            f"{expected} ({epochs} epochs of {steps})")
    losses = [h["train_epoch/train_avg_loss"] for h in trainer.history]
    if not all(math.isfinite(x) for x in losses) or not math.isfinite(
            summary["test_epoch/test_avg_loss"]):
        raise AssertionError(f"non-finite losses: {losses}, {summary}")
    last = [t for e, t in ends if e == epochs - 1]
    if len(ends) != epochs * steps["train"] or len(last) < 2:
        raise AssertionError(f"timed {len(ends)} train steps")
    step_ms = [(b - a) * 1e3 for a, b in zip(last, last[1:])]
    median = statistics.median(step_ms)
    epoch_s = trainer.history[-1]["train_epoch/epoch_time_sec"]
    log(f"[loop] {card}: {launches} log_spectrogram launches ({epochs} x "
        f"{steps['train']} train, {epochs} x {steps['val']} val, "
        f"{steps['test']} test steps); train losses {losses}; test loss "
        f"{summary['test_epoch/test_avg_loss']:.5f}; run {wall:.1f} s")
    log(f"[loop] {card}: epoch-2 train step through the Loader ({workers} "
        f"gather threads, prefetch 2), median {median:.2f} ms over "
        f"{len(step_ms)} steps (each {', '.join(f'{m:.2f}' for m in step_ms)}"
        f"); the whole epoch {epoch_s * 1e3 / steps['train']:.2f} ms a step "
        f"with its start; the fixture's step with its batch on the card "
        f"{fixture_ms:.2f} ms (phase 7); host feed adds "
        f"{median - fixture_ms:.2f} ms a step")
    # the feed alone, no step: the producer's host work per batch (gather
    # on the threads, pad, cast), then with the pinning and the copy
    feed = trainer.train_loader
    feed.set_epoch(epochs - 1)
    t = time.perf_counter()
    n = sum(1 for _ in feed._host_batches())
    host_ms = (time.perf_counter() - t) * 1e3 / n
    feed.set_epoch(epochs - 1)
    t = time.perf_counter()
    n = sum(1 for _ in feed)
    torch.cuda.synchronize()
    feed_ms = (time.perf_counter() - t) * 1e3 / n
    log(f"[loop] {card}: the Loader alone, {n} batches of {BATCH}: host "
        f"batch (gather, pad, cast) {host_ms:.2f} ms, with pinning and the "
        f"copy to the card {feed_ms:.2f} ms a batch")
    for entry in kernels:
        if entry["name"] == "log_spectrogram":
            # phase 7's count beside this slice's path through the loop
            entry["launches_fixture"] = entry["launches"]
            entry["launches"] = launches


def phase_switched_towers(device, card: str):
    """The two full-width bf16 towers with ``bn_fused=True,
    pool_kernel="pallas"`` against the same towers with the switches off,
    from the same weights, on the main path's preprocessed inputs.  One
    warm-up pass of each (forward and backward of both towers): the
    switched one records the shape of every kernel call.  The outputs and
    stem-conv gradients of both are held against the same towers in fp32
    (TOWER_RATIO).  Then timed passes in turns off, on, on, off, ...  Each
    switched pass must launch 40 BN sums forward, 40 backward, and 2
    max-pools each way.  Returns (the warm-up pass's recorded calls, the
    timed passes' launches)."""
    from multimodal_clinical_tpu_torch.benchmarks import vggsound
    from multimodal_clinical_tpu_torch.engine.state import step_generator
    from multimodal_clinical_tpu_torch.models.common import init_weights
    from multimodal_clinical_tpu_torch.models.resnet import ResNetEncoder

    gen = np.random.default_rng(0)
    wave = torch.from_numpy(gen.normal(scale=0.1, size=(BATCH, 80000)).astype(
        np.float32)).to(device)
    frames = torch.from_numpy(gen.normal(size=(BATCH, 4, 224, 224, 3)).astype(
        np.float32)).to(device, torch.bfloat16)
    with torch.no_grad():
        pre = vggsound.device_preprocess({"x1_waveform": wave, "x2": frames},
                                         step_generator(0, 0), True)
    inputs = (pre["x1"], pre["x2"].flatten(0, 1))
    del wave, frames, pre
    if tuple(inputs[0].shape) != AUDIO_TOWER or tuple(
            inputs[1].shape) != VISUAL_TOWER:
        raise AssertionError(f"tower inputs {[tuple(x.shape) for x in inputs]}")

    def towers(dtype=torch.bfloat16, **switches):
        pair = []
        for seed, cin in enumerate((1, 3)):
            enc = ResNetEncoder(cin, dtype=dtype, **switches)
            init_weights(enc, torch.Generator().manual_seed(seed))
            pair.append(enc.to(device, memory_format=torch.channels_last))
        return pair

    configs = {"off": towers(), "on": towers(bn_fused=True,
                                            pool_kernel="pallas")}
    cot_gen = torch.Generator(device="cuda").manual_seed(4)
    cotangents = []

    def one_pass(pair):
        """Outputs and stem-conv weight gradients of both towers."""
        outs, grads = [], []
        for i, (enc, x) in enumerate(zip(pair, inputs)):
            enc.zero_grad(set_to_none=True)
            out = enc(x)
            if len(cotangents) < 2:
                cotangents.append(torch.randn(
                    out.shape, device=device, dtype=out.dtype,
                    generator=cot_gen))
            out.backward(cotangents[i].to(out.dtype))
            outs.append(out.detach())
            grads.append(enc.conv1.weight.grad)
        return outs, grads

    with _recording_calls() as calls:
        on = one_pass(configs["on"])
    off = one_pass(configs["off"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reference = one_pass(towers(torch.float32))
    torch.cuda.synchronize()
    for fwd, bwd in (("bn_sums", "bn_bwd_sums"),
                     ("maxpool_fwd", "maxpool_bwd")):
        if collections.Counter(calls[fwd]) != collections.Counter(calls[bwd]):
            raise AssertionError(f"switched towers: {fwd} saw {calls[fwd]}, "
                                 f"{bwd} saw {calls[bwd]}")
    diffs = {}
    for k, what in enumerate(("outputs", "stem-conv gradients")):
        for a, b in zip(on[k] + off[k], reference[k] * 2):
            if not (a.shape == b.shape and torch.isfinite(a).all()):
                raise AssertionError(f"switched towers: {what} not finite or "
                                     f"misshaped")

        def err(got, want):
            return max(_scaled_err(a.float(), b.float())
                       for a, b in zip(got, want))

        d = diffs[what] = {"switched": err(on[k], reference[k]),
                           "default": err(off[k], reference[k]),
                           "apart": err(on[k], off[k])}
        if not d["switched"] <= TOWER_RATIO * d["default"]:
            raise AssertionError(
                f"switched towers: {what} differ from the fp32 towers' by "
                f"{d['switched']:.3e} of the largest entry, the default "
                f"towers' by {d['default']:.3e} (limit {TOWER_RATIO} times)")
    del on, off, reference

    launchers = _switch_launchers()
    for fn in launchers.values():
        fn.launches = 0
    times = {"off": [], "on": []}
    peak = {"off": 0.0, "on": 0.0}
    order = ["off", "on", "on", "off"] * ((TOWER_TIMED + 1) // 2)
    for name in order[:2 * TOWER_TIMED]:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        one_pass(configs[name])
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t) * 1e3)
        peak[name] = max(peak[name],
                         torch.cuda.max_memory_allocated() / 2**30)
    launches = {n: fn.launches for n, fn in launchers.items()}
    profiles = {name: _profile_pass(one_pass, pair)
                for name, pair in configs.items()}
    per_pass = {"bn_sums": 40, "bn_bwd_sums": 40, "maxpool_fwd": 2,
                "maxpool_bwd": 2}
    recorded = {n: len(c) for n, c in calls.items()}
    if launches != {n: TOWER_TIMED * c for n, c in per_pass.items()} or (
            recorded != per_pass):
        raise AssertionError(f"switched towers: launches {launches} in "
                             f"{TOWER_TIMED} passes and {recorded} calls in "
                             f"the warm-up pass, expected {per_pass} per "
                             f"pass")
    med = {n: statistics.median(v) for n, v in times.items()}
    log(f"[towers] {card}: audio {AUDIO_TOWER} + visual {VISUAL_TOWER} "
        f"bf16, forward and backward: switches off median {med['off']:.2f} ms "
        f"(each {', '.join(f'{m:.2f}' for m in times['off'])}), peak "
        f"{peak['off']:.2f} GiB; bn_fused + pool_kernel='pallas' median "
        f"{med['on']:.2f} ms (each {', '.join(f'{m:.2f}' for m in times['on'])}"
        f"), peak {peak['on']:.2f} GiB; launches in {TOWER_TIMED} switched "
        f"passes {launches}")
    for what, d in diffs.items():
        log(f"[towers] {what}, in units of the fp32 towers' largest entry: "
            f"switched towers {d['switched']:.3e} from them, default towers "
            f"{d['default']:.3e} (ratio "
            f"{d['switched'] / max(d['default'], 1e-30):.3f}); "
            f"switched and default {d['apart']:.3e} apart")
    for name, (families, top) in profiles.items():
        log(f"[towers] traced pass, switches {name}, device ms by family: "
            + ", ".join(f"{fam} {us / 1e3:.3f}" for fam, us in sorted(
                families.items(), key=lambda kv: -kv[1])))
        for us, kernel in top:
            log(f"[towers]   {us / 1e3:9.3f} ms  {kernel[:110]}")
    del configs, inputs, cotangents
    torch.cuda.empty_cache()
    return calls, launches


def _profile_pass(one_pass, pair, top: int = 12):
    """One pass of both towers under ``torch.profiler``: device time by
    kernel family, and the ``top`` kernels, in microseconds."""
    from torch.profiler import ProfilerActivity, profile

    from multimodal_clinical_tpu_torch.benchmarks.profile_vggsound import (
        family_times, kernel_times,
    )

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one_pass(pair)
        torch.cuda.synchronize()
    kernels = kernel_times(prof)
    return family_times(kernels), sorted(
        ((us, name) for name, us in kernels.items()), reverse=True)[:top]


def _probe_launchers():
    """The wrappers of the tool probes' kernels."""
    from multimodal_clinical_tpu_torch.ops import cuda_bn_stats as cbs
    from multimodal_clinical_tpu_torch.ops import cuda_conv3x3 as ccv
    from multimodal_clinical_tpu_torch.ops import cuda_identity as cid

    return {"conv3x3": ccv.launch_conv3x3, "bn_stats": cbs.launch_bn_stats,
            "identity_copy": cid.launch_identity}


def phase_probes(card: str):
    """Phase 9: each ported probe's ``main`` at the TPU probe's full
    geometries (they print their own lines), launch counts set to 0 just
    before and read just after.  Returns the launches."""
    from multimodal_clinical_tpu_torch.tools import (
        probe_pallas_layout, proto_bn_stats, proto_pallas_conv,
    )

    launchers = _probe_launchers()
    for fn in launchers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    proto_pallas_conv.main(check=False, iters=PROBE_ITERS)
    proto_bn_stats.main(iters=PROBE_ITERS)
    probe_pallas_layout.main(iters=PROBE_ITERS)
    launches = {name: fn.launches for name, fn in launchers.items()}
    log(f"[probes] {card}: the three probes' mains in "
        f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    missing = [name for name, count in launches.items() if not count]
    if missing:
        raise AssertionError(f"probe kernels not launched by their probes: "
                             f"{missing}")
    torch.cuda.empty_cache()
    return launches


def _within_ulp(got, want, what: str) -> Tuple[float, ...]:
    """(largest |kernel - plain| over CONV_ULP_RTOL max(|kernel|, |plain|)
    + CONV_ULP_ATOL max |plain|, share of entries that differ at all,
    largest |kernel - plain|, largest |plain|); raises past 1."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    limit = CONV_ULP_RTOL * torch.maximum(got.abs(), want.abs()) + (
        CONV_ULP_ATOL * float(want.abs().max()))
    worst = float((diff / limit.clamp_min(1e-30)).max())
    if not worst <= 1.0:
        raise AssertionError(f"conv3x3 {what}: kernel and plain differ by "
                             f"{worst:.3f} of the limit")
    return (worst, float((diff > 0).float().mean()), float(diff.max()),
            float(want.abs().max()))


def _conv_case(shape, seed: int):
    b, h, w, cin, cout = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, h, w, cin, device="cuda", generator=gen).to(
        torch.bfloat16)
    wt = (torch.randn(3, 3, cin, cout, device="cuda", generator=gen)
          * 0.05).to(torch.bfloat16)
    return x, wt


def _check_conv(x, wt, what: str):
    from multimodal_clinical_tpu_torch.ops import cuda_conv3x3 as ccv
    from multimodal_clinical_tpu_torch.ops.conv3x3 import conv3x3

    got = ccv.launch_conv3x3(x, wt)
    torch.cuda.synchronize()
    checks = _within_ulp(got, conv3x3(x, wt), what)
    if not torch.equal(got, ccv.launch_conv3x3(x, wt)):
        raise AssertionError(f"conv3x3 {what}: two launches differ")
    return checks


def _check_stats(x, what: str):
    from multimodal_clinical_tpu_torch.ops import cuda_bn_stats as cbs
    from multimodal_clinical_tpu_torch.ops.bn_stats import bn_stats

    got = cbs.launch_bn_stats(x)
    torch.cuda.synchronize()
    want = bn_stats(x)
    x32 = x.reshape(-1, x.shape[-1]).float()
    errs = [(got[0] - want[0]).abs(), (got[1] - want[1]).abs()]
    scales = [x32.abs().mean(0), x32.square().mean(0)]
    del x32
    rel = [float((e / s.clamp_min(1e-30)).max())
           for e, s in zip(errs, scales)]
    if not (rel[0] <= STATS_MEAN_TOL and rel[1] <= STATS_VAR_TOL):
        raise AssertionError(f"bn_stats {what}: mean and var differ by "
                             f"{rel[0]:.3e} and {rel[1]:.3e} of their scale")
    again = cbs.launch_bn_stats(x)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"bn_stats {what}: two launches differ")
    return max(float(e.max()) for e in errs), rel


def _check_copy(x, what: str):
    from multimodal_clinical_tpu_torch.ops import cuda_identity as cid
    from multimodal_clinical_tpu_torch.ops.identity import identity

    got = cid.launch_identity(x)
    torch.cuda.synchronize()
    if not (got.stride() == x.stride() and torch.equal(got, identity(x))):
        raise AssertionError(f"identity_copy {what}: kernel and plain differ")


def _entry(name, src, replaces, launches, err, rows, **extra):
    """A kernels-line entry: times and bounds summed over ``rows``, one per
    probe geometry (ms, plain_ms, library_ms, bytes_ms, ops_ms)."""
    total = {k: sum(r[k] for r in rows) for k in (
        "ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")}
    return {
        "name": name,
        "route": "cuda",
        "source": f"multimodal_clinical_tpu_torch/csrc/{src}",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        **extra,
        # one call at each of the probe's geometries; every time is the sum
        # (the log has each geometry's)
        "shapes": [r["shape"] for r in rows],
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": sum(max(r["bytes_ms"], r["ops_ms"]) for r in rows),
        "bound_by": ("bytes" if total["bytes_ms"] >= total["ops_ms"]
                     else "operations"),
        "library_ms": total["library_ms"],
    }


def phase_probe_kernels(launches):
    """Phase 10: the conv, BN-stats and copy kernels against their plain
    versions at every geometry the probes ran (fresh random inputs of the
    same shapes) and at ragged shapes, timed beside their bound, plain
    version and library call."""
    from multimodal_clinical_tpu_torch.ops import cuda_bn_stats as cbs
    from multimodal_clinical_tpu_torch.ops import cuda_conv3x3 as ccv
    from multimodal_clinical_tpu_torch.ops import cuda_fused_bn as cfb
    from multimodal_clinical_tpu_torch.ops import cuda_identity as cid
    from multimodal_clinical_tpu_torch.ops.bn_stats import bn_stats
    from multimodal_clinical_tpu_torch.ops.conv3x3 import conv3x3
    from multimodal_clinical_tpu_torch.ops.identity import identity
    from multimodal_clinical_tpu_torch.tools import (
        probe_pallas_layout, proto_bn_stats, proto_pallas_conv,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entries = []

    # conv: ragged shapes first (W = 5, 20, 79, 157; H W and B H W not
    # multiples of the 128-row tile; Cin = 16, a ragged K step; Cout not a
    # multiple of the tile), then the probe's 8 geometries
    worst = share = err = rel = 0.0
    for shape in ((3, 5, 5, 16, 16), (2, 7, 20, 32, 48), (1, 9, 79, 64, 64),
                  (3, 3, 157, 16, 32), (1, 4, 6, 128, 144),
                  (7, 13, 157, 64, 64)):
        w_, s_, e, scale = _check_conv(*_conv_case(shape, seed=sum(shape)),
                                       str(shape))
        err, worst, share = max(err, e), max(worst, w_), max(share, s_)
        rel = max(rel, e / scale)
    log(f"[probe-kernels] conv3x3 ragged shapes: {worst:.3f} of the one-ulp "
        f"limit, max |err| {err:.3e} ({rel:.2e} of the largest entry), at "
        f"most {share:.2e} of entries differ")
    rows = []
    for name, b, h, w, cin, cout, _ in proto_pallas_conv.GEOMS:
        x, wt = _conv_case((b, h, w, cin, cout), seed=cin)
        w_, s_, e, scale = _check_conv(x, wt, name)
        err, worst, rel = max(err, e), max(worst, w_), max(rel, e / scale)
        x_nchw = x.permute(0, 3, 1, 2)
        w_oihw = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        m = b * h * w
        row = dict(
            shape=(b, h, w, cin, cout),
            ms=cuda_ms(lambda: ccv.launch_conv3x3(x, wt)),
            plain_ms=cuda_ms(lambda: conv3x3(x, wt), iters=5),
            library_ms=cuda_ms(lambda: F.conv2d(x_nchw, w_oihw, padding=1)),
            bytes_ms=2 * (m * cin + m * cout + 9 * cin * cout)
            / PEAK_BYTES_PER_S * 1e3,
            ops_ms=2 * m * cout * 9 * cin / PEAK_BF16_FLOPS * 1e3)
        rows.append(row)
        log(f"[probe-kernels] conv3x3 {name} {row['shape']}: "
            f"{row['ms']:.4f} ms ({row['ops_ms'] / row['ms'] * 100:.1f}% of "
            f"the bf16 peak), plain {row['plain_ms']:.4f}, F.conv2d "
            f"{row['library_ms']:.4f} "
            f"({row['ops_ms'] / row['library_ms'] * 100:.1f}%), bound "
            f"{max(row['bytes_ms'], row['ops_ms']):.4f}; {w_:.3f} of the "
            f"one-ulp limit, max |err| {e:.3e} ({e / scale:.2e} of the largest "
            f"entry), {s_:.2e} of entries differ")
        del x, wt, x_nchw, w_oihw
    entries.append(_entry(
        "conv3x3", "conv3x3.cu",
        "tools/proto_pallas_conv.py:69 conv_pallas", launches["conv3x3"],
        err, rows, max_share_of_ulp_limit=worst,
        max_err_of_largest_entry=rel))
    torch.cuda.empty_cache()

    # BN stats: ragged (M not a multiple of a block's rows; C = 24, and 96:
    # a 64-channel group and a 32-channel one), then the probe's 3
    # geometries
    err, rel = 0.0, [0.0, 0.0]
    gen = torch.Generator(device="cuda").manual_seed(6)
    for m, c, dtype in ((1_000_003, 64, torch.bfloat16),
                        (1003, 128, torch.float32), (513, 24, torch.float32),
                        (37, 512, torch.bfloat16), (2001, 96, torch.bfloat16)):
        x = torch.randn(m, c, device="cuda", generator=gen).add_(0.5).to(dtype)
        e, r = _check_stats(x, f"({m}, {c}) {dtype}")
        err, rel = max(err, e), [max(a, b) for a, b in zip(rel, r)]
    rows = []
    for name, (n, h, w, _, c) in proto_bn_stats.GEOMS.items():
        x = torch.randn(n, h, w, c, device="cuda", generator=gen).add_(
            0.5).to(torch.bfloat16)
        e, r = _check_stats(x, name)
        err, rel = max(err, e), [max(a, b) for a, b in zip(rel, r)]
        x_nchw = x.permute(0, 3, 1, 2)
        row = dict(shape=(n, h, w, c),
                   ms=cuda_ms(lambda: cbs.launch_bn_stats(x)),
                   plain_ms=cuda_ms(lambda: bn_stats(x)),
                   library_ms=cuda_ms(lambda: torch.batch_norm_stats(
                       x_nchw, 1e-5)),
                   bytes_ms=(2 * x.numel() + 8 * c) / PEAK_BYTES_PER_S * 1e3,
                   ops_ms=2 * x.numel() / PEAK_FP32_FLOPS * 1e3)
        rows.append(row)
        log(f"[probe-kernels] bn_stats {name} {row['shape']} bf16: "
            f"{row['ms']:.4f} ms ({row['bytes_ms'] / row['ms'] * 100:.1f}% "
            f"of the bandwidth), plain {row['plain_ms']:.4f}, "
            f"batch_norm_stats {row['library_ms']:.4f}, bound "
            f"{row['bytes_ms']:.4f}; mean and var within {r[0]:.2e} and "
            f"{r[1]:.2e} of their scale")
        del x, x_nchw
    # the one-pass statistics against the BN-sums forward (csrc/bn_sums.cu:
    # the same reads and a last-block fold, sums out), at the probe's maps
    # and at the towers' stage-4 maps, where a launch costs as much as the
    # reads
    stats_vs_sums = []
    for shape in [*(g[:3] + g[4:] for g in proto_bn_stats.GEOMS.values()),
                  (896, 7, 7, 512), (224, 5, 20, 512)]:
        x = torch.randn(shape, device="cuda", generator=gen).to(
            torch.bfloat16)
        stats_vs_sums.append((shape, cuda_ms(lambda: cbs.launch_bn_stats(x)),
                              cuda_ms(lambda: cfb.launch_channel_sums(x))))
        log(f"[probe-kernels] BN statistics {shape} bf16: bn_stats "
            f"{stats_vs_sums[-1][1]:.4f} ms, bn_sums "
            f"{stats_vs_sums[-1][2]:.4f} ms, bound "
            f"{2 * x.numel() / PEAK_BYTES_PER_S * 1e3:.4f} ms")
        del x
    entries.append(_entry(
        "bn_stats", "bn_stats.cu", "tools/proto_bn_stats.py:59 "
        "pallas_bn_stats", launches["bn_stats"], err, rows,
        max_rel_err_mean=rel[0], max_rel_err_var=rel[1],
        stats_vs_sums_ms=stats_vs_sums))
    torch.cuda.empty_cache()

    # copy: ragged (a 2-byte tail, uint8, an NCHW channels_last map), then
    # the layout probe's conv output and its (H, W, C, N) view
    for x in (torch.randn(1001, device="cuda").bfloat16(),
              torch.randint(0, 255, (4099,), device="cuda",
                            dtype=torch.uint8),
              torch.randn(5, 16, 9, 3, device="cuda").to(
                  memory_format=torch.channels_last)):
        _check_copy(x, f"{tuple(x.shape)} {x.dtype}")
    n, h, w, _, c = probe_pallas_layout.GEOM
    t = torch.randn(n, h, w, c, device="cuda", generator=gen).to(
        torch.bfloat16)
    rows = []
    for label, view in (("NHWC map", t), ("(H, W, C, N) view",
                                          t.permute(1, 2, 3, 0))):
        _check_copy(view, label)
        row = dict(shape=tuple(view.shape),
                   ms=cuda_ms(lambda: cid.launch_identity(view)),
                   plain_ms=cuda_ms(lambda: identity(view)),
                   library_ms=cuda_ms(lambda: view.clone()),
                   bytes_ms=2 * 2 * view.numel() / PEAK_BYTES_PER_S * 1e3,
                   ops_ms=0.0)
        rows.append(row)
        log(f"[probe-kernels] identity_copy {label} {row['shape']} bf16: "
            f"{row['ms']:.4f} ms ({row['bytes_ms'] / row['ms'] * 100:.1f}% "
            f"of the bandwidth), plain {row['plain_ms']:.4f}, clone "
            f"{row['library_ms']:.4f}, bound {row['bytes_ms']:.4f}; "
            f"bit-equal")
    del t, view
    entries.append(_entry(
        "identity_copy", "identity_copy.cu",
        "tools/probe_pallas_layout.py:45 pallas_identity",
        launches["identity_copy"], 0.0, rows))
    torch.cuda.empty_cache()
    for e in entries:
        log(f"[probe-kernels] {e['name']}, one call at each of "
            f"{len(e['shapes'])} probe shapes: {e['ms']:.4f} ms, plain "
            f"{e['plain_ms']:.4f} ms, library {e['library_ms']:.4f} ms, "
            f"bound {e['bound_ms']:.4f} ms ({e['bound_by']}), "
            f"{e['bound_ms'] / e['ms'] * 100:.1f}% of it (library "
            f"{e['bound_ms'] / e['library_ms'] * 100:.1f}%; kernel / library "
            f"{e['ms'] / e['library_ms']:.3f}); launches on the probes' path "
            f"{e['launches']}")
    return entries


# -- phases 13-15: the other contracts, Crema-D and AVE ---------------------

# phase 13: a narrow fp32 Crema-D net, card against CPU, for each contract
# (model type, OGM mode); two steps, the second batch with a padded tail
CONTRACT_CASES = (("jlogits", None), ("ensemble", None), ("ogm_ge", "OGM"),
                  ("ogm_ge", "OGM_GE"), ("qmf", None),
                  ("ogm_ge_lreg", "OGM_GE"))
CONTRACT_ROWS, CONTRACT_VALID, CONTRACT_TABLE = 6, 4, 12
# 6713 samples: cremad_spectrogram's 257 bins by 40 frames
CONTRACT_SAMPLES = 512 + 159 * 39
# the QMF History, card against CPU: the batch-mean CE and logsumexp / 10
# of the logits, continuous in the inputs, so as close as the losses in
# fp32; in float64 the logits agree to ~1e-12 before the tables' fp32
# casts, so the tables to an ulp or two
CPU_TABLE_RTOL, CPU_TABLE_ATOL = 1e-4, 1e-6
F64_TABLE_RTOL, F64_TABLE_ATOL = 1e-6, 1e-7
# phase 14: Crema-D and AVE at the published geometry (configs/cremad.yaml,
# configs/ave.yaml; data/synthetic.py): batch 64, 10 s at 16 kHz
FULL_BATCH, FULL_SAMPLES, FULL_IMAGE, FULL_TIMED = 64, 160000, 224, 3
# the History's rows: Crema-D's 7442 clips (its train split is a part)
CREMAD_CLIPS = 7442
# rows of the batch with a padded tail (the QMF scatter check)
FULL_VALID = 60


def _contract_batches(dev, seed: int = 0):
    """Two narrow Crema-D batches from numpy's ``seed`` generator: the
    first full, the second with a padded tail (the last real row repeated,
    ``idx`` included)."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(CONTRACT_TABLE)
    out = []
    for step, real in enumerate((CONTRACT_ROWS, CONTRACT_VALID)):
        rows = np.arange(CONTRACT_ROWS).clip(max=real - 1)
        wave = rng.normal(scale=0.1, size=(CONTRACT_ROWS, CONTRACT_SAMPLES))
        frames = rng.integers(0, 256, size=(CONTRACT_ROWS, 1, 32, 32, 3),
                              dtype=np.uint8)
        label = rng.integers(0, 6, size=CONTRACT_ROWS)
        idx = ids[step * CONTRACT_ROWS:(step + 1) * CONTRACT_ROWS]
        valid = (np.arange(CONTRACT_ROWS) < real).astype(np.float32)
        out.append({k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                    for k, v in (("x1_waveform", wave[rows].astype(
                        np.float32)), ("x2", frames[rows]),
                        ("label", label[rows]), ("idx", idx[rows]),
                        ("valid", valid))})
    return out


def _contract_noise():
    """One standard-normal CPU draw per conv weight of the narrow net, by
    name: the same OGM-GE noise on the card and on the CPU."""
    from multimodal_clinical_tpu_torch.algos.ogm_ge import (
        modulated_parameters,
    )
    from multimodal_clinical_tpu_torch.models.zoo import CremadFusionNet

    gen = torch.Generator().manual_seed(7)
    return {name: torch.randn(p.shape, generator=gen)
            for _, name, p in modulated_parameters(
                CremadFusionNet(6, width=8))}


def _contract_steps(dev, dtype, model_type, mode, noise, preprocess=None):
    """Two train steps of the narrow Crema-D net under ``model_type`` on
    ``dev``: losses, the initial and final state_dict, momentum buffers,
    EMA and QMF tables, on the CPU."""
    import dataclasses

    from multimodal_clinical_tpu_torch.benchmarks import cremad
    from multimodal_clinical_tpu_torch.engine.state import create_train_state
    from multimodal_clinical_tpu_torch.engine.steps import make_train_step
    from multimodal_clinical_tpu_torch.models.zoo import CremadFusionNet

    args = SimpleNamespace(num_classes=6, batch_size=CONTRACT_ROWS,
                           learning_rate=1e-2, num_epochs=60,
                           use_scheduler=False, seed=0,
                           model_type=model_type, alpha=0.8,
                           grad_mod_type=mode or "OGM_GE")
    spec, _ = cremad.get_model_spec(args, n_train=CONTRACT_TABLE)
    spec = dataclasses.replace(
        spec, module=CremadFusionNet(6, width=8),
        device_preprocess=preprocess or spec.device_preprocess)
    state = create_train_state(spec, args, seed=0, steps_per_epoch=100,
                               device=dev)
    state.model.to(dtype)
    cpu = lambda t: t.detach().cpu().clone()
    init = {k: cpu(v) for k, v in state.model.state_dict().items()}
    step = make_train_step(spec, ogm_noise=lambda _: (
        lambda name, g: noise[name].to(g.device)))
    losses = []
    for batch in _contract_batches(dev):
        state, metrics = step(state, batch)
        losses.append(float(metrics["train_loss"]))
    named = dict(state.model.named_parameters())
    tables = None
    if state.qmf_correctness is not None:
        tables = (cpu(state.qmf_correctness), cpu(state.qmf_confidence))
    return dict(
        losses=losses, init=init, tables=tables,
        final={k: cpu(v) for k, v in state.model.state_dict().items()},
        momentum={k: cpu(state.optimizer.state[p]["momentum_buffer"])
                  for k, p in named.items()},
        ema=cpu(state.ema))


def _check_tables(card, host, rtol, atol, what, batches=None):
    """The QMF tables, card against CPU, written at the real idx of
    ``batches`` (by default phase 13's) only."""
    if card["tables"] is None and host["tables"] is None:
        return "no tables"
    seen = np.unique(np.concatenate([
        b["idx"][b["valid"] > 0].numpy()
        for b in batches or _contract_batches("cpu")]))
    for name, got, want in zip(("correctness", "confidence"), card["tables"],
                               host["tables"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {name}")
        written = np.flatnonzero((got != 0).any(dim=0).numpy())
        if not np.array_equal(written, seen):
            raise AssertionError(f"{what}: {name} written at {written}, the "
                                 f"batches' real idx are {seen}")
    return (f"tables within {_scaled_err(card['tables'][0], host['tables'][0]):.2e}"
            f" / {_scaled_err(card['tables'][1], host['tables'][1]):.2e}")


def phase_contracts_card_against_cpu(device):
    """Phase 13: each contract on a narrow Crema-D net, card against CPU,
    from the same weights, inputs and OGM noise.

    fp32 (TF32 off), each device with its own preprocess: the losses, BN
    buffers, EMA and QMF tables, which are continuous in the inputs (see
    phase 6 for why parameter updates are not compared in fp32).  float64,
    both devices fed the card's preprocessed batch: parameter updates and
    momentum buffers held to F64_TOL of each tensor's largest entry, the
    losses to F64_LOSS_RTOL, the tables to F64_TABLE_RTOL."""
    from multimodal_clinical_tpu_torch.benchmarks import cremad

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    cpu = torch.device("cpu")
    noise = _contract_noise()

    def shared(batch, generator, train):
        out = cremad.device_preprocess(
            {k: v.to(device) for k, v in batch.items()}, generator, train)
        dev = batch["label"].device
        return {k: (v.double() if k in ("x1", "x2") else v).to(dev)
                for k, v in out.items()}

    for model_type, mode in CONTRACT_CASES:
        what = model_type + (f" ({mode})" if mode else "")
        card, host = (_contract_steps(device, torch.float32, model_type, mode,
                                      noise),
                      _contract_steps(cpu, torch.float32, model_type, mode,
                                      noise))
        _compare_fp32_steps(card, host, f"Crema-D {what}")
        fp32_tables = _check_tables(card, host, CPU_TABLE_RTOL,
                                    CPU_TABLE_ATOL, what)
        card, host = (_contract_steps(device, torch.float64, model_type, mode,
                                      noise, shared),
                      _contract_steps(cpu, torch.float64, model_type, mode,
                                      noise, shared))
        np.testing.assert_allclose(card["losses"], host["losses"],
                                   rtol=F64_LOSS_RTOL)
        worst = {"update": 0.0, "momentum": 0.0}
        for key, want in host["final"].items():
            if "running" in key or "num_batches" in key:
                continue
            pairs = {"update": (card["final"][key] - card["init"][key],
                                want - host["init"][key]),
                     "momentum": (card["momentum"][key],
                                  host["momentum"][key])}
            for kind, (got, ref) in pairs.items():
                err = _scaled_err(got, ref)
                worst[kind] = max(worst[kind], err)
                if not err <= F64_TOL:
                    raise AssertionError(
                        f"Crema-D {what} {key} {kind}: card and CPU differ "
                        f"by {err:.3e} of its largest entry")
        f64_tables = _check_tables(card, host, F64_TABLE_RTOL, F64_TABLE_ATOL,
                                   what)
        log(f"[contracts] card against CPU, Crema-D {what}: fp32 {fp32_tables}"
            f"; float64 losses card {card['losses']} cpu {host['losses']}, "
            f"updates within {worst['update']:.2e}, momentum within "
            f"{worst['momentum']:.2e}, {f64_tables}")


def _full_batch(bench: str, frames: int, classes: int, device, valid: int):
    """A full-width batch on the card from numpy's seed-0 generator:
    ``x1_waveform`` of 10 s at 16 kHz, uint8 frames of 224 x 224, labels,
    distinct ``idx`` in the Crema-D table; the last ``FULL_BATCH - valid``
    rows repeat the last real one, ``idx`` included."""
    rng = np.random.default_rng(0)
    rows = np.arange(FULL_BATCH).clip(max=valid - 1)
    wave = rng.normal(scale=0.1, size=(FULL_BATCH, FULL_SAMPLES)).astype(
        np.float32)
    x2 = rng.integers(0, 256, size=(FULL_BATCH, frames, FULL_IMAGE,
                                    FULL_IMAGE, 3), dtype=np.uint8)
    label = rng.integers(0, classes, size=FULL_BATCH)
    idx = rng.permutation(CREMAD_CLIPS)[:FULL_BATCH]
    batch = {"x1_waveform": wave[rows], "x2": x2[rows], "label": label[rows],
             "idx": idx[rows],
             "valid": (np.arange(FULL_BATCH) < valid).astype(np.float32)}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def _drive_model_type(device, card: str, bench: str, model_type: str,
                      batches, expected=None, pool_kernel: str = "xla",
                      state_from=None):
    """One warm-up step on ``batches[0]``, FULL_TIMED timed steps and one
    eval step on ``batches[1]`` of ``bench``'s ``model_type`` at full
    width, from the benchmark's own spec and device preprocess.  Raises
    unless every loss is finite, the eval output is finite, the QMF
    History changed exactly at the warm-up batch's real ``idx``, and the
    kernels launched as ``expected``.  Returns (step ms, launches)."""
    import dataclasses
    import importlib

    from multimodal_clinical_tpu_torch.config import load_config
    from multimodal_clinical_tpu_torch.engine.state import create_train_state
    from multimodal_clinical_tpu_torch.engine.steps import (
        make_eval_step, make_train_step,
    )
    from multimodal_clinical_tpu_torch.models.zoo import CremadFusionNet

    module = importlib.import_module(
        f"multimodal_clinical_tpu_torch.benchmarks.{bench}")
    args = load_config(bench, overrides=dict(model_type=model_type))
    rows = int(batches[0]["label"].shape[0])
    spec, _ = module.get_model_spec(args, n_train=CREMAD_CLIPS)
    tag = f"[{bench} {model_type}" + (
        f" pool_kernel={pool_kernel!r}]" if pool_kernel != "xla" else "]")
    torch.cuda.reset_peak_memory_stats()
    if state_from is None:
        if pool_kernel != "xla":
            spec = dataclasses.replace(spec, module=CremadFusionNet(
                int(args.num_classes), dtype=spec.module.x1_classifier.dtype,
                pool_kernel=pool_kernel))
        state = create_train_state(spec, args, int(args.seed),
                                   steps_per_epoch=100, device=device)
    else:
        # the fixture's state and towers under this model type's spec
        state = state_from
        spec = dataclasses.replace(spec, module=state.model)
    train_step, eval_step = make_train_step(spec), make_eval_step(spec)
    tables = None
    if state.qmf_correctness is not None:
        tables = (state.qmf_correctness.clone(), state.qmf_confidence.clone())
    launchers = _all_launchers()
    for fn in launchers.values():
        fn.launches = 0
    losses, step_ms = [], []
    for i in range(1 + FULL_TIMED):
        t = time.perf_counter()
        state, metrics = train_step(state, batches[min(i, 1)])
        torch.cuda.synchronize()
        elapsed = (time.perf_counter() - t) * 1e3
        losses.append(float(metrics["train_loss"]))
        if i:
            step_ms.append(elapsed)
        if i == 0 and tables is not None:
            batch = batches[0]
            real = torch.unique(batch["idx"][batch["valid"] > 0])
            changed = ((state.qmf_correctness != tables[0])
                       | (state.qmf_confidence != tables[1])).any(dim=0)
            written = torch.nonzero(changed)[:, 0]
            if spec.qmf_ablate_train:
                real = real[:0]  # trains plain joint logits
            if not torch.equal(written.cpu(), real.cpu()):
                raise AssertionError(
                    f"{tag} the History changed at {written.numel()} rows, "
                    f"the batch's real idx are {real.numel()} rows")
    out = eval_step(state, batches[1])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in launchers.items()}
    classes = int(args.num_classes)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag} non-finite train loss: {losses}")
    if out["logits_stack"].shape != (rows, 2, classes) or not bool(
            torch.isfinite(out["logits_stack"]).all()) or not math.isfinite(
                float(out["loss"])):
        raise AssertionError(f"{tag} eval output is not finite or misshaped")
    for name, count in launches.items():
        if count != (expected or {}).get(name, 0):
            raise AssertionError(f"{tag} {name} launched {count} times, "
                                 f"expected {(expected or {}).get(name, 0)}")
    median = statistics.median(step_ms)
    log(f"{tag} {card}: train step median {median:.2f} ms over {FULL_TIMED} "
        f"(each {', '.join(f'{m:.2f}' for m in step_ms)}); "
        f"{rows / median * 1e3:.1f} samples/s at batch {rows}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; warm-up "
        f"loss {losses[0]:.5f}, eval loss {float(out['loss']):.5f}"
        + (" (History written at the real idx only)" if tables is not None
           else "") + f"; launches {launches}")
    del state, train_step, eval_step, out
    torch.cuda.empty_cache()
    return median, launches


def phase_full_width(device, card: str, kernels):
    """Phase 14: Crema-D's ten and AVE's three model types at the published
    geometry, nothing cut; one Crema-D ogm_ge run with the stored-index
    max-pool, whose kernels are then held against their plain versions at
    the shapes that run gave them; then VGGSound's jlogits and ensemble
    at batch 224 from waveforms, the log-STFT's launches asserted."""
    from multimodal_clinical_tpu_torch.benchmarks import ave, cremad
    from multimodal_clinical_tpu_torch.benchmarks.vggsound_fixture import (
        build_vggsound_bench,
    )

    by_path = collections.defaultdict(dict)
    pool_shapes = {}
    train_steps = 1 + FULL_TIMED
    for bench, module, frames, classes in (
            ("cremad", cremad, 3, 6), ("ave", ave, ave.NUM_FRAMES, 28)):
        t = time.perf_counter()
        batches = [_full_batch(bench, frames, classes, device, FULL_VALID),
                   _full_batch(bench, frames, classes, device, FULL_BATCH)]
        log(f"[{bench}] batches of {FULL_BATCH} x {FULL_SAMPLES} samples and "
            f"{frames} uint8 frames of 224 x 224 made in "
            f"{time.perf_counter() - t:.1f} s")
        for model_type in module.MODEL_TYPES:
            _drive_model_type(device, card, bench, model_type, batches)
        if bench == "cremad":
            # OGM-GE's walk over the 4-D parameters of the switched towers:
            # two stem max-pools each way per train step, none in eval
            with _recording_calls() as calls:
                step_ms, launches = _drive_model_type(
                    device, card, bench, "ogm_ge", batches,
                    expected={"maxpool_fwd": 2 * train_steps,
                              "maxpool_bwd": 2 * train_steps},
                    pool_kernel="pallas")
            SINGLE_STEP_MS[("cremad", "ogm_ge")] = step_ms
            for name in ("maxpool_fwd", "maxpool_bwd"):
                by_path[name]["cremad_ogm_ge_pallas"] = launches[name]
            pool_shapes["cremad_ogm_ge_pallas"] = _check_path_pools(
                calls, "cremad ogm_ge pool_kernel='pallas'")
        del batches
        torch.cuda.empty_cache()
    for model_type in ("jlogits", "ensemble"):
        _, state, batch, _ = build_vggsound_bench(BATCH, CLASSES,
                                                  device=device)
        # one log-STFT launch per train and eval step
        _, launches = _drive_model_type(
            device, card, "vggsound", model_type, [batch, batch],
            expected={"log_spectrogram": train_steps + 1}, state_from=state)
        by_path["log_spectrogram"][f"vggsound_{model_type}"] = launches[
            "log_spectrogram"]
        del state, batch
        torch.cuda.empty_cache()
    for entry in kernels:
        if entry["name"] in by_path:
            entry.setdefault("launches_by_path", {}).update(
                by_path[entry["name"]])
        if entry["name"] in ("maxpool_fwd", "maxpool_bwd"):
            entry.setdefault("checked_shapes_by_path", {}).update(pool_shapes)


def _check_path_pools(calls, what: str):
    """Both max-pool kernels against their plain versions (exactly) at
    every NHWC shape that a path's run gave them (``calls``, recorded by
    ``_recording_calls``), on a post-ReLU bf16 map as the stem gives;
    returns the shapes."""
    fwd, bwd = (collections.Counter(calls[n])
                for n in ("maxpool_fwd", "maxpool_bwd"))
    if fwd != bwd or not fwd:
        raise AssertionError(f"{what}: maxpool_fwd saw {dict(fwd)}, "
                             f"maxpool_bwd saw {dict(bwd)}")
    for shape in sorted(fwd):
        gen = torch.Generator(device="cuda").manual_seed(3)
        x = torch.randn(shape, device="cuda", dtype=torch.bfloat16,
                        generator=gen).clamp_min_(0)
        _check_pool(x, f"{what} {shape}")
        del x
    log(f"[kernels] max-pool at the shapes of {what} "
        f"({', '.join(f'{s} x{n}' for s, n in sorted(fwd.items()))}): "
        f"forward and backward equal to the plain version")
    torch.cuda.empty_cache()
    return [list(s) for s in sorted(fwd)]


def phase_contracts_cli(device):
    """Phase 15: the CLI's ``--dir cremad --set model_type=qmf`` at full
    width on the synthetic twin, two epochs; then ``--resume`` for a third,
    whose restored History tables must equal the saved ones; then ``--dir
    ave`` for one epoch; all in process through ``__main__.run_training``."""
    from multimodal_clinical_tpu_torch import __main__ as cli
    from multimodal_clinical_tpu_torch.engine import run

    work = WORK_DIR / "contracts_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        base = ["--set", f"ckpt_dir={work}", "--set", f"data_path={work}/none"]
        qmf = base + ["--set", "model_type=qmf"]
        out = _cli(qmf + ["--set", "num_epochs=2"], bench="cremad",
                   device=device)
        summary = ast.literal_eval(out.strip().splitlines()[-1])
        if not math.isfinite(summary.get("test_epoch/test_avg_df_acc",
                                         math.nan)):
            raise AssertionError(f"no test_epoch/test_avg_df_acc: {summary}")
        ckpt = work / "cremad_cls6" / "ckpt"
        names = sorted(os.listdir(ckpt))
        if names != ["best", "last-1", "last-2", "meta.json"]:
            raise AssertionError(f"checkpoint directory: {names}")
        saved = torch.load(ckpt / "last-2" / "state.pt", map_location="cpu",
                           weights_only=True)
        restored = {}

        class Watched(run.Trainer):
            def resume(self):
                found = super().resume()
                restored.update(
                    step=int(self.state.step),
                    corr=self.state.qmf_correctness.cpu().clone(),
                    conf=self.state.qmf_confidence.cpu().clone())
                return found

        trainer_cls, run.Trainer = run.Trainer, Watched
        try:
            t = time.perf_counter()
            cli.run_training(["--dir", "cremad", *qmf, "--set",
                              "num_epochs=3", "--resume"], device=device)
            wall = time.perf_counter() - t
        finally:
            run.Trainer = trainer_cls
        if (restored.get("step") != 2
                or not torch.equal(restored["corr"], saved["qmf_correctness"])
                or not torch.equal(restored["conf"], saved["qmf_confidence"])
                or not bool(saved["qmf_correctness"].any())):
            raise AssertionError("--resume did not restore the saved History "
                                 f"(step {restored.get('step')})")
        meta = json.loads((ckpt / "meta.json").read_text())
        if meta["epochs_done"] != 3:
            raise AssertionError(f"--resume: meta {meta}")
        log(f"[cli] cremad qmf --resume in process ({wall:.1f} s): restored "
            f"step 2 and the saved History, {int((saved['qmf_correctness'] != 0).sum())}"
            f" of {saved['qmf_correctness'].numel()} entries written; three "
            f"epochs done")
        out = _cli(base + ["--set", "num_epochs=1"], bench="ave",
                   device=device)
        summary = ast.literal_eval(out.strip().splitlines()[-1])
        rows = _epoch_rows(work / "ave_cls28_jprobas_seeds")
        if (not math.isfinite(summary.get("avg_test_acc", math.nan))
                or [r["epoch"] for r in rows] != [0, -1]):
            raise AssertionError(f"ave: summary {summary}, rows {rows}")
        log(f"[cli] ave one epoch: test_avg_acc "
            f"{summary['test_epoch/test_avg_acc']:.4f} (legacy alias "
            f"avg_test_acc {summary['avg_test_acc']:.4f})")
    finally:
        shutil.rmtree(work, ignore_errors=True)


# -- phase 16: the disk feed --------------------------------------------------

# the corpora's clip counts, cut from the real ones (PERF.md section 4); the
# per-sample geometry is the published one (benchmarks/disk_fixture.py):
# VGGSound 10 s wavs and 10 JPEGs of 640 x 360 at quality 93, Crema-D 2.5 s
# wavs and 3 JPEGs of 480 x 360, AVE 10 JPEGs of 640 x 360
DISK_VGGSOUND = (2 * BATCH, BATCH)        # train, test clips; 309 classes
DISK_CREMAD = (128, 64)                   # train, test; the six emotions
DISK_AVE = (128, 64, 64)                  # train, val, test; 28 events
DISK_EPOCHS = 2
# Crema-D's stream mode on the card against its CPU-made pickles: the same
# cremad_spectrogram, an fp32 rfft on the card against one on the CPU
# (another FFT, another order of sums) before the log and the per-clip
# standardisation; held to 1e-4 of the largest entry
DISK_SPEC_TOL = 1e-4
DISK_DIR = WORK_DIR / "disk"


def _host_decoders():
    """{library: why it loads or not}, and the JPEG path a frame takes."""
    import ctypes

    from multimodal_clinical_tpu_torch.utils import avdecode, native

    found = {}
    for module in (native, avdecode):
        name = os.path.basename(module.LIB_PATH)
        try:
            ctypes.CDLL(module.LIB_PATH)
            found[name] = "loads"
        except OSError as exc:
            found[name] = f"does not load ({exc})"
        if (found[name] == "loads") != module.available():
            raise AssertionError(f"{name}: {found[name]}, but available() "
                                 f"is {module.available()}")
    frame = next((DISK_DIR / "vggsound" / "frames").glob("*/0000.jpg"))
    jpeg = ("native libjpeg" if native.jpeg_dims(str(frame)) is not None
            else "PIL")
    return found, jpeg


def phase_disk_build():
    """Phase 16a: the corpora in the reference's layouts (VGGSound,
    Crema-D with pickles and with wavs, AVE with pickles) under
    ``DISK_DIR``; a few dozen distinct files, each written under many
    clips' names."""
    from multimodal_clinical_tpu_torch.benchmarks import disk_fixture as df

    shutil.rmtree(DISK_DIR, ignore_errors=True)
    trees = {name: str(DISK_DIR / name) + "/" for name in (
        "vggsound", "cremad_pkl", "cremad_stream", "ave_pkl")}
    t = time.perf_counter()
    made = {
        "vggsound": df.build_vggsound_tree(trees["vggsound"], *DISK_VGGSOUND,
                                           CLASSES),
        "cremad_pkl": df.build_cremad_tree(trees["cremad_pkl"], *DISK_CREMAD,
                                           "pkl"),
        "cremad_stream": df.build_cremad_tree(trees["cremad_stream"],
                                              *DISK_CREMAD, "stream"),
        "ave_pkl": df.build_ave_tree(trees["ave_pkl"], *DISK_AVE, "pkl"),
    }
    log(f"[disk] corpora written in {time.perf_counter() - t:.1f} s: "
        + ", ".join(f"{k} {v['clips']} clips {v['bytes'] / 1e6:.1f} MB"
                    for k, v in made.items())
        + " (read back from the page cache: no disk reads are timed)")
    return trees


def _check_first_batch(loader, dataset, what: str):
    """The first batch of epoch 0 as it reaches the card through the pinned
    side-stream copy equals the dataset's gather at the sampler's indices
    (its float features cast as the Loader casts them), bit for bit;
    returns the gather."""
    loader.set_epoch(0)
    idx = np.asarray(loader.sampler.indices(0))[:loader.batch_size]
    it = iter(loader)
    batch = next(it)
    torch.cuda.synchronize()
    it.close()
    want = dataset.gather(idx)
    if not np.array_equal(batch["idx"].cpu().numpy(), idx):
        raise AssertionError(f"{what}: first batch idx differ")
    for key, arr in want.items():
        got, arr = batch[key], loader._host_tensor(key, arr)
        if got.device != loader.device or not torch.equal(got.cpu(), arr):
            raise AssertionError(f"{what}: first batch {key} differs from "
                                 "the gather")
    log(f"[disk] {what}: the first train batch on the card equals the "
        f"gather at the sampler's indices bit for bit "
        f"({', '.join(f'{k} {tuple(v.shape)} {v.dtype}' for k, v in want.items())})")
    return want


def _host_breakdown(dataset, loader, card: str, host_ms: float) -> None:
    """Where a VGGSound host batch goes, on this thread alone, over the
    first 32 clips of epoch 1: a wav read, a frame's decode (PIL's open
    and RGB convert alone), a frame's whole train transform, a clip's
    gather; then what the Loader's threads made of it."""
    from multimodal_clinical_tpu_torch.benchmarks import vggsound
    from multimodal_clinical_tpu_torch.data.core import sample_rng
    from multimodal_clinical_tpu_torch.data.imageops import (
        _pil_open, load_frame_train_u8,
    )

    sub = np.asarray(loader.sampler.indices(1))[:32]
    clips = [dataset.items[int(i)][0] for i in sub]
    frames = [str(p) for c in clips for p in sorted(
        (Path(dataset.data_dir) / "frames" / c).iterdir())[:4]]
    t = time.perf_counter()
    for c in clips:
        vggsound._read_audio(dataset.data_dir, c)
    wav_ms = (time.perf_counter() - t) * 1e3 / len(clips)
    t = time.perf_counter()
    for f in frames:
        _pil_open(f)
    decode_ms = (time.perf_counter() - t) * 1e3 / len(frames)
    t = time.perf_counter()
    for k, f in enumerate(frames):
        load_frame_train_u8(f, sample_rng(0, 1, k))
    frame_ms = (time.perf_counter() - t) * 1e3 / len(frames)
    dataset.set_epoch(1)
    t = time.perf_counter()
    dataset.gather(sub)
    clip_ms = (time.perf_counter() - t) * 1e3 / len(sub)
    one_thread = clip_ms * loader.batch_size
    log(f"[disk] {card}: one thread, 32 clips: a 10 s wav {wav_ms:.2f} ms; "
        f"a 640 x 360 JPEG frame {frame_ms:.2f} ms through the train "
        f"transform, {decode_ms:.2f} ms of it PIL's decode; a clip's gather "
        f"(wav, crop, {dataset.use_video_frames} frames) {clip_ms:.2f} ms, "
        f"{one_thread:.0f} ms a batch of {loader.batch_size}; the Loader's "
        f"{loader.workers} threads made it in {host_ms:.0f} ms, "
        f"{one_thread / host_ms:.2f}x one thread ({os.cpu_count()} cores, "
        f"{len(os.sched_getaffinity(0))} usable)")


def phase_disk_vggsound(device, card: str, trees, kernels):
    """Phase 16b: VGGSound jprobas through ``get_data`` on the disk corpus
    at batch 224, two epochs of two steps, with the config's loader
    threads: the Loader alone, the epoch-2 step through it, the log-STFT's
    launches; the first batch on the card against its gather, the log-STFT
    against its plain version on disk waveforms; then the CLI on the
    corpus, and ``--resume`` for a third epoch."""
    from multimodal_clinical_tpu_torch.benchmarks import vggsound
    from multimodal_clinical_tpu_torch.config import load_config
    from multimodal_clinical_tpu_torch.engine import run
    from multimodal_clinical_tpu_torch.ops import cuda_spectrogram as cs
    from multimodal_clinical_tpu_torch.ops import spectrogram as plain

    decoders, jpeg = _host_decoders()
    log(f"[disk] host decoders: {decoders}; JPEG frames decode through "
        f"{jpeg}")
    work = DISK_DIR / "runs"
    args = load_config("vggsound", overrides=dict(
        num_epochs=DISK_EPOCHS, ckpt_dir=str(work), data_path=trees[
            "vggsound"]))
    workers = run.resolve_loader_workers(args)
    data = vggsound.get_data(args)
    if data.synthetic or not isinstance(data.train,
                                        vggsound.VGGSoundDiskDataset):
        raise AssertionError("get_data did not read the disk corpus")
    train_loader = run.build_loaders(args, data, device)[0]
    first = _check_first_batch(train_loader, data.train, "VGGSound")

    # the Loader alone, two epochs' batches: the host batch (gathers on the
    # threads, pad, cast), then with the pinning and the copy to the card
    t = time.perf_counter()
    n = 0
    for epoch in (1, 2):
        train_loader.set_epoch(epoch)
        n += sum(1 for _ in train_loader._host_batches())
    host_ms = (time.perf_counter() - t) * 1e3 / n
    t = time.perf_counter()
    for epoch in (1, 2):
        train_loader.set_epoch(epoch)
        for _ in train_loader:
            pass
    torch.cuda.synchronize()
    feed_ms = (time.perf_counter() - t) * 1e3 / n
    log(f"[disk] {card}: the Loader alone on the VGGSound corpus, {n} "
        f"batches of {BATCH}, {workers} gather threads: host batch "
        f"{host_ms:.2f} ms, with pinning and the copy to the card "
        f"{feed_ms:.2f} ms a batch")

    _host_breakdown(data.train, train_loader, card, host_ms)

    wave = torch.from_numpy(first["x1_waveform"]).to(device)
    max_err, clear_err = compare_spectrogram(
        cs.launch_log_spectrogram(wave, 256, 128),
        plain.log_spectrogram(wave, 256, 128))
    log(f"[kernels] log_spectrogram on the first batch's disk waveforms "
        f"{tuple(wave.shape)}: max |log err| {max_err:.3e}, in clear bins "
        f"{clear_err:.3e}")
    del wave, first

    ends, seen = [], {}

    class TimedTrainer(run.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["trainer"] = self
            step = self.train_step

            def timed(state, batch):
                state, metrics = step(state, batch)
                torch.cuda.synchronize()
                ends.append((self.train_loader._epoch, time.perf_counter()))
                return state, metrics

            self.train_step = timed

    shutil.rmtree(work, ignore_errors=True)
    module = SimpleNamespace(get_data=lambda _: data,
                             get_model_spec=vggsound.get_model_spec)
    trainer_cls, run.Trainer = run.Trainer, TimedTrainer
    torch.cuda.reset_peak_memory_stats()
    cs.launch_log_spectrogram.launches = 0
    try:
        t = time.perf_counter()
        summary = run.run_benchmark(args, module, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        run.Trainer = trainer_cls
    launches = cs.launch_log_spectrogram.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    trainer = seen["trainer"]
    steps = {split: len(getattr(trainer, f"{split}_loader"))
             for split in ("train", "val", "test")}
    expected = DISK_EPOCHS * (steps["train"] + steps["val"]) + steps["test"]
    if launches != expected:
        raise AssertionError(f"[disk] log_spectrogram launched {launches} "
                             f"times, expected {expected} ({steps})")
    losses = [h["train_epoch/train_avg_loss"] for h in trainer.history]
    if not all(math.isfinite(x) for x in losses) or not math.isfinite(
            summary["test_epoch/test_avg_loss"]):
        raise AssertionError(f"non-finite losses: {losses}, {summary}")
    last = [t for e, t in ends if e == DISK_EPOCHS - 1]
    if len(ends) != DISK_EPOCHS * steps["train"] or len(last) < 2:
        raise AssertionError(f"timed {len(ends)} train steps")
    step_ms = [(b - a) * 1e3 for a, b in zip(last, last[1:])]
    median = statistics.median(step_ms)
    epoch_s = trainer.history[-1]["train_epoch/epoch_time_sec"]
    log(f"[disk] {card}: VGGSound jprobas on the disk corpus ({steps}), "
        f"{launches} log_spectrogram launches, as its steps; train losses "
        f"{losses}; test loss {summary['test_epoch/test_avg_loss']:.5f}; "
        f"run {wall:.1f} s")
    log(f"[disk] {card}: epoch-2 train step through the Loader "
        f"{median:.2f} ms (each {', '.join(f'{m:.2f}' for m in step_ms)}), "
        f"{BATCH / median * 1e3:.1f} samples/s; the whole epoch "
        f"{epoch_s * 1e3 / steps['train']:.2f} ms a step with its start; "
        f"peak memory {peak:.2f} GiB")
    for entry in kernels:
        if entry["name"] == "log_spectrogram":
            entry.setdefault("launches_by_path", {})["vggsound_disk"] = (
                launches)
    del trainer, seen, data, train_loader
    torch.cuda.empty_cache()

    shutil.rmtree(work, ignore_errors=True)
    base = ["--set", f"ckpt_dir={work}", "--set",
            f"data_path={trees['vggsound']}"]
    out = _cli(base + ["--set", f"num_epochs={DISK_EPOCHS}"], device=device)
    summary = ast.literal_eval(out.strip().splitlines()[-1])
    if not math.isfinite(summary.get("test_epoch/test_avg_acc", math.nan)):
        raise AssertionError(f"no test_epoch/test_avg_acc: {summary}")
    out = _cli(base + ["--set", f"num_epochs={DISK_EPOCHS + 1}", "--resume"],
               device=device)
    done = DISK_EPOCHS * steps["train"]
    meta = json.loads((work / RUN_NAME / "ckpt" / "meta.json").read_text())
    if (f"[trainer] resumed from step {done}" not in out
            or meta["epochs_done"] != DISK_EPOCHS + 1):
        raise AssertionError(f"--resume on the disk corpus: meta {meta}")
    log(f"[cli] vggsound on the disk corpus: {DISK_EPOCHS} epochs, then "
        f"--resume from step {done} for one more; test_avg_acc "
        f"{summary['test_epoch/test_avg_acc']:.4f}")


def phase_disk_contracts(device, card: str, trees, kernels):
    """Phase 16c-d: the Crema-D qmf CLI on the pickle corpus for two epochs
    and ``--resume`` for a third; Crema-D ogm_ge on the wav corpus (stream
    mode, spectrogram on the card) for one epoch with
    ``pool_kernel="pallas"``, both max-pool kernels counted; the AVE CLI on
    its pickle corpus for one epoch; then stream mode's spectrograms on the
    card against the pickles of the same clips."""
    import dataclasses

    from multimodal_clinical_tpu_torch.benchmarks import cremad
    from multimodal_clinical_tpu_torch.config import load_config
    from multimodal_clinical_tpu_torch.engine import run
    from multimodal_clinical_tpu_torch.models.zoo import CremadFusionNet

    work = DISK_DIR / "runs"
    shutil.rmtree(work, ignore_errors=True)
    steps = -(-DISK_CREMAD[0] // FULL_BATCH)
    qmf = ["--set", f"ckpt_dir={work}", "--set",
           f"data_path={trees['cremad_pkl']}", "--set", "model_type=qmf"]
    out = _cli(qmf + ["--set", "num_epochs=2"], bench="cremad", device=device)
    summary = ast.literal_eval(out.strip().splitlines()[-1])
    if not math.isfinite(summary.get("test_epoch/test_avg_df_acc",
                                     math.nan)):
        raise AssertionError(f"no test_epoch/test_avg_df_acc: {summary}")
    out = _cli(qmf + ["--set", "num_epochs=3", "--resume"], bench="cremad",
               device=device)
    meta = json.loads((work / "cremad_cls6" / "ckpt" / "meta.json")
                      .read_text())
    if (f"[trainer] resumed from step {2 * steps}" not in out
            or meta["epochs_done"] != 3):
        raise AssertionError(f"cremad --resume on the pickles: meta {meta}")
    log(f"[cli] cremad qmf on the pickle corpus: two epochs, then --resume "
        f"from step {2 * steps} for a third")

    out = _cli(["--set", f"ckpt_dir={work}", "--set",
                f"data_path={trees['ave_pkl']}", "--set", "num_epochs=1"],
               bench="ave", device=device)
    summary = ast.literal_eval(out.strip().splitlines()[-1])
    rows = _epoch_rows(work / "ave_cls28_jprobas_seeds")
    if (not math.isfinite(summary.get("avg_test_acc", math.nan))
            or [r["epoch"] for r in rows] != [0, -1]):
        raise AssertionError(f"ave: summary {summary}, rows {rows}")
    log(f"[cli] ave on the pickle corpus, one epoch: test_avg_acc "
        f"{summary['test_epoch/test_avg_acc']:.4f}")

    # ogm_ge, stream mode, the stored-index max-pool: two launches each way
    # a train step (one per tower's stem), none in eval
    seen = {}

    def get_data(args):
        seen["data"] = cremad.get_data(args)
        return seen["data"]

    def get_model_spec(args, n_train):
        spec, kw = cremad.get_model_spec(args, n_train)
        return dataclasses.replace(spec, module=CremadFusionNet(
            int(args.num_classes), dtype=spec.module.x1_classifier.dtype,
            pool_kernel="pallas")), kw

    args = load_config("cremad", overrides=dict(
        model_type="ogm_ge", num_epochs=1, ckpt_dir=str(work / "ogm"),
        data_path=trees["cremad_stream"]))
    launchers = _all_launchers()
    for fn in launchers.values():
        fn.launches = 0
    t = time.perf_counter()
    summary = run.run_benchmark(args, SimpleNamespace(
        get_data=get_data, get_model_spec=get_model_spec), device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {name: fn.launches for name, fn in launchers.items()}
    expected = {"maxpool_fwd": 2 * steps, "maxpool_bwd": 2 * steps}
    if (seen["data"].train.audio_mode != "stream"
            or launches != {n: expected.get(n, 0) for n in launches}
            or not math.isfinite(summary["test_epoch/test_avg_loss"])):
        raise AssertionError(f"cremad ogm_ge stream pool_kernel='pallas': "
                             f"launches {launches}, summary {summary}")
    log(f"[disk] {card}: cremad ogm_ge on the wav corpus (spectrogram on the "
        f"card), pool_kernel='pallas', one epoch of {steps} steps in "
        f"{wall:.1f} s: launches {launches}")
    for entry in kernels:
        if entry["name"] in expected:
            entry.setdefault("launches_by_path", {})[
                "cremad_ogm_ge_disk_stream_pallas"] = launches[entry["name"]]

    # stream mode's spectrogram on the card against the CPU-made pickles
    idx = np.arange(FULL_BATCH)
    pkl = cremad.get_data(SimpleNamespace(data_path=trees["cremad_pkl"],
                                          seed=5, num_classes=6))
    want = torch.from_numpy(pkl.train.gather(idx)["x1"][..., 0])
    wave = seen["data"].train.gather(idx)["x1_waveform"]
    got = cremad.cremad_spectrogram(torch.from_numpy(wave).to(device)).cpu()
    gap = float((got - want).abs().max()) / float(want.abs().max())
    if got.shape != (FULL_BATCH, 257, 1004) or not gap <= DISK_SPEC_TOL:
        raise AssertionError(f"stream spectrogram {tuple(got.shape)} differs "
                             f"from the pickles by {gap:.3e} of the largest "
                             "entry")
    log(f"[disk] Crema-D stream mode: the card's (257, 1004) spectrograms of "
        f"{FULL_BATCH} clips against their CPU-made pickles: max gap "
        f"{gap:.3e} of the largest entry (limit {DISK_SPEC_TOL:g})")
    shutil.rmtree(work, ignore_errors=True)


# -- phase 17: AV-MNIST, MIMIC and MUsTARD ------------------------------------

# the three benchmarks' classes and per-sample shapes (configs/*.yaml,
# data/synthetic.py); AV-MNIST's inputs are pixel values / 255
SMALL_BENCHES = {
    "avmnist": (10, [(28, 28, 1), (112, 112, 1)]),
    "mimic": (6, [(5,), (24, 12)]),
    "mustard": (2, [(40, 371), (40, 81), (40, 300)]),
}
# 17a: card against CPU, two steps of SMALL_ROWS rows (the second with
# SMALL_VALID real ones) from the same weights, at the published geometry;
# each case's learning rate is the config's, capped at SMALL_CPU_LR (phase
# 13's) where it is a float, and the config's own (MIMIC's 0.1) where None
SMALL_CPU_LR = 1e-2
SMALL_CASES = (("avmnist", "jlogits", SMALL_CPU_LR),
               ("mimic", "jprobas", SMALL_CPU_LR), ("mimic", "jprobas", None),
               ("mimic", "jlogits", SMALL_CPU_LR),
               ("mustard", "jlogits", SMALL_CPU_LR))
SMALL_ROWS, SMALL_VALID, SMALL_TABLE = 6, 4, 12
# Adam at MIMIC's 0.1 moves the entries whose gradient is within rounding
# of zero by up to 0.1 each, differently on each device, and the second
# step's float64 loss carries that: card against CPU 2.4e-6 and 8.4e-7
# apart on the H100 in two runs, under F64_LOSS_RTOL at 1e-2.  Its
# witness, logged beside it: the CPU against itself with the classes
# permuted (SMALL_PERMS), the same training with the fp32 loss summed over
# the classes in another order, 1.9e-7 to 5.6e-7 apart at 0.1 and 0 at 1e-2
ADAM_RATE_LOSS_RTOL = 1e-5
SMALL_PERMS = ((5, 4, 3, 2, 1, 0), (1, 2, 3, 4, 5, 0), (3, 0, 4, 1, 5, 2))
# Adam moves an entry by lr * m / (sqrt(v) + eps) whatever its gradient's
# size, and the loss is fp32 by design (so are its logit gradients in the
# float64 runs): where a step's gradient entry is within that rounding of
# zero, card and CPU move it by different shares of the learning rate.  The
# updates under Adam are held where both devices' gradient entries agree to
# ADAM_GRAD_RTOL at both steps, at least ADAM_HELD_SHARE of each tensor,
# where a gradient's share of rounding moves its update by at most
# lr * ADAM_GRAD_RTOL / 4, inside F64_TOL; the moments everywhere
ADAM_GRAD_RTOL, ADAM_HELD_SHARE = 1e-4, 0.9
# 17b: the published batch (configs/{avmnist,mimic,mustard}.yaml), its
# last SMALL_BATCH_VALID rows real in the warm-up step's batch; the QMF
# History at MIMIC's train split, 80% of its 36 212 admissions
SMALL_BATCH, SMALL_BATCH_VALID, SMALL_TIMED = 32, 28, 20
MIMIC_TRAIN = 28970
# 17c: the model type each benchmark's two-epoch CLI and --resume run; the
# benchmark whose two-epoch run is a ``python3 -m`` subprocess (a fresh
# process takes ~20 s to start on the card; the others call the same
# ``__main__.run_training`` in process)
SMALL_CLI = {"avmnist": "jlogits", "mimic": "qmf", "mustard": "jlogits"}
SMALL_CLI_PROCESS = "mustard"
# 17d: the files' row counts, cut from the real ones (AV-MNIST 60 000 +
# 10 000 of which 55 000 train, MIMIC 36 212, MUsTARD 690)
SMALL_FILES = {"avmnist": (55000 + 320, 320), "mimic": 4096,
               "mustard": (256, 64, 64)}


def _small_batches(bench: str, dev, rows: int, valid, table: int,
                   seed: int = 0):
    """Train batches of ``rows`` at ``bench``'s per-sample geometry from
    numpy's ``seed`` generator, one per entry of ``valid`` (its count of
    real rows; the rest repeat the last real one, ``idx`` included), with
    distinct ``idx`` below ``table``."""
    classes, shapes = SMALL_BENCHES[bench]
    rng = np.random.default_rng(seed)
    ids = rng.permutation(table)
    out = []
    for step, real in enumerate(valid):
        pick = np.arange(rows).clip(max=real - 1)
        batch = {}
        for i, shape in enumerate(shapes):
            x = (rng.random((rows,) + shape) if bench == "avmnist"
                 else rng.normal(size=(rows,) + shape))
            batch[f"x{i + 1}"] = x.astype(np.float32)[pick]
        batch["label"] = rng.integers(0, classes, rows)[pick]
        batch["idx"] = ids[(step * rows) % table:][:rows][pick]
        batch["valid"] = (np.arange(rows) < real).astype(np.float32)
        out.append({k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                    for k, v in batch.items()})
    return out


def _small_state(bench: str, model_type: str, dev, n_train: int,
                 **overrides):
    """(spec, state, args) of ``bench``'s ``model_type`` from its config,
    its spec and optimizer arguments, seed-0 weights."""
    import importlib

    from multimodal_clinical_tpu_torch.config import load_config
    from multimodal_clinical_tpu_torch.engine.state import create_train_state

    module = importlib.import_module(
        f"multimodal_clinical_tpu_torch.benchmarks.{bench}")
    args = load_config(bench, overrides=dict(model_type=model_type,
                                             **overrides))
    spec, opt = module.get_model_spec(args, n_train=n_train)
    state = create_train_state(spec, args, 0, steps_per_epoch=100,
                               device=dev, **opt)
    return spec, state, args


def _small_lr(bench: str, cap) -> float:
    """``bench``'s configured learning rate, capped at ``cap`` unless None."""
    from multimodal_clinical_tpu_torch.config import load_config

    lr = float(load_config(bench).learning_rate)
    return lr if cap is None else min(lr, cap)


def _small_steps(dev, dtype, bench: str, model_type: str, lr: float,
                 perm=None):
    """Two train steps of ``bench``'s ``model_type`` in fp32 compute
    (``dtype`` the parameters' and inputs'): losses, the initial and final
    state_dict, each step's gradients, the optimizer's per-parameter state
    and the EMA, on the CPU.  ``perm``, a permutation of the classes, is
    applied to the net's logits and the labels: the same training, its
    fp32 loss summed over the classes in another order."""
    from multimodal_clinical_tpu_torch.engine.steps import make_train_step

    spec, state, _ = _small_state(bench, model_type, dev, SMALL_TABLE,
                                  compute_dtype="float32", learning_rate=lr)
    state.model.to(dtype)
    if perm is not None:
        perm = torch.as_tensor(perm, device=dev)
        state.model.register_forward_hook(lambda m, args, out: {
            **out, "logits": [x[:, perm] for x in out["logits"]]})
    cpu = lambda t: t.detach().cpu().clone()
    init = {k: cpu(v) for k, v in state.model.state_dict().items()}
    step = make_train_step(spec)
    named = dict(state.model.named_parameters())
    losses, grads = [], []
    for batch in _small_batches(bench, dev, SMALL_ROWS,
                                (SMALL_ROWS, SMALL_VALID), SMALL_TABLE):
        batch = {k: v.to(dtype) if k.startswith("x") else v
                 for k, v in batch.items()}
        if perm is not None:  # class c now sits where perm holds c
            batch["label"] = torch.argsort(perm)[batch["label"]]
        state, metrics = step(state, batch)
        losses.append(float(metrics["train_loss"]))
        grads.append({k: cpu(p.grad) for k, p in named.items()})
    moments = {k: {n: cpu(v) for n, v in state.optimizer.state[p].items()
                   if torch.is_tensor(v) and v.shape == p.shape}
               for k, p in named.items()}
    return dict(losses=losses, init=init, grads=grads, moments=moments,
                final={k: cpu(v) for k, v in state.model.state_dict().items()},
                ema=cpu(state.ema), adam="exp_avg" in next(
                    iter(moments.values())))


# attention's key bias: the softmax over the keys is shift invariant, so
# its gradient is zero in exact arithmetic and rounding on each device,
# below ROUNDING_GRAD; Adam moves each such entry by up to about the
# learning rate a step, in the direction the rounding gives it
ROUNDING_GRAD = 1e-6


def _compare_f64_small_steps(card, host, what: str, at_rate: bool = False,
                             rounding=()):
    """Two float64 runs of ``_small_steps``: the losses to F64_LOSS_RTOL;
    parameter updates (under Adam where held) and the optimizer's state to
    F64_TOL of each tensor's largest entry.  ``at_rate`` (Adam at MIMIC's
    0.1): the second loss to ADAM_RATE_LOSS_RTOL, and ADAM_HELD_SHARE of
    the first step's gradient entries (the second step's part widely, from
    weights the first step moved by up to 0.1 apart).  Keys ending in one
    of ``rounding``: both devices' gradients below ROUNDING_GRAD and their
    updates within twice the learning rate a step.  Returns the log line's
    tail."""
    np.testing.assert_allclose(card["losses"][:1], host["losses"][:1],
                               rtol=F64_LOSS_RTOL)
    np.testing.assert_allclose(
        card["losses"], host["losses"],
        rtol=ADAM_RATE_LOSS_RTOL if at_rate else F64_LOSS_RTOL)
    worst = {"update": 0.0, "state": 0.0}
    shares = []
    for key, want in host["final"].items():
        if "running" in key or "num_batches" in key:
            continue
        got_update = card["final"][key] - card["init"][key]
        want_update = want - host["init"][key]
        if key.endswith(tuple(rounding)):
            bound = 2 * host["lr"] * len(host["grads"])
            grads = [s[key] for run in (card, host) for s in run["grads"]]
            if (max(float(g.abs().max()) for g in grads) > ROUNDING_GRAD
                    or float(got_update.abs().max()) > bound
                    or float(want_update.abs().max()) > bound):
                raise AssertionError(f"{what} {key}: a gradient beyond "
                                     "rounding, or an update beyond 2 lr")
            continue
        if host["adam"]:
            g = torch.stack([s[key] for s in card["grads"]])
            h = torch.stack([s[key] for s in host["grads"]])
            agree = (g - h).abs() <= ADAM_GRAD_RTOL * h.abs()
            held = agree.all(0)
            shares.append(float((agree[0] if at_rate else held).double()
                                .mean()))
            if shares[-1] < ADAM_HELD_SHARE:
                raise AssertionError(
                    f"{what} {key}: only {shares[-1]:.3f} of its "
                    "gradient entries agree to ADAM_GRAD_RTOL")
            got_update, want_update = got_update[held], want_update[held]
        pairs = [("update", got_update, want_update)] + [
            ("state", card["moments"][key][n], ref)
            for n, ref in host["moments"][key].items()]
        for kind, got, ref in pairs:
            err = _scaled_err(got, ref)
            worst[kind] = max(worst[kind], err)
            if not err <= F64_TOL:
                raise AssertionError(
                    f"{what} {key} {kind}: card and CPU differ by "
                    f"{err:.3e} of its largest entry")
    held = (f"; Adam updates held at {min(shares):.3f}-{max(shares):.3f}"
            " of each tensor's entries" + (" (first step)" if at_rate else "")
            if shares else "")
    return (f"updates within {worst['update']:.2e}, optimizer state within "
            f"{worst['state']:.2e}{held}")


def _loss_gap(a, b) -> float:
    """The second step's losses' relative distance."""
    return abs(a["losses"][1] - b["losses"][1]) / abs(b["losses"][1])


def _torch_settings():
    """(matmul TF32, cuDNN TF32, CPU threads)."""
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, torch.get_num_threads())


# what a process starts with, and so what the CLI runs under
TORCH_DEFAULTS = _torch_settings()


@contextlib.contextmanager
def _torch_set(matmul_tf32: bool, cudnn_tf32: bool, threads: int):
    """The settings of ``_torch_settings`` for the block, restored after."""
    before = _torch_settings()

    def put(settings):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = settings[:2]
        torch.set_num_threads(settings[2])

    put((matmul_tf32, cudnn_tf32, threads))
    try:
        yield
    finally:
        put(before)


def phase_small_card_against_cpu(device):
    """Phase 17a: AV-MNIST jlogits (plain SGD), MIMIC jprobas (Adam, at
    SMALL_CPU_LR and at the config's 0.1) and jlogits (SGD with momentum)
    and MUsTARD jlogits (Adam, three towers), two train steps on the card
    and on the CPU from the same weights and inputs.  fp32 (TF32 off):
    losses, BN buffers and EMA.  float64: ``_compare_f64_small_steps``,
    the second loss to ADAM_RATE_LOSS_RTOL at MIMIC's 0.1, beside its
    witness (the CPU against itself with the classes permuted).  The CPU
    side runs on 2 threads: PyTorch's CPU convolution backward crashed at
    some small channels_last shapes on 4."""
    cpu = torch.device("cpu")
    with _torch_set(False, False, 2):
        for bench, model_type, cap in SMALL_CASES:
            lr = _small_lr(bench, cap)
            what = f"{bench} {model_type} at lr {lr:g}"
            card, host = (
                _small_steps(device, torch.float32, bench, model_type, lr),
                _small_steps(cpu, torch.float32, bench, model_type, lr))
            _compare_fp32_steps(card, host, what)
            card, host = (
                _small_steps(device, torch.float64, bench, model_type, lr),
                _small_steps(cpu, torch.float64, bench, model_type, lr))
            tail = _compare_f64_small_steps(card, host, what,
                                            at_rate=cap is None)
            if cap is None:
                gaps = [_loss_gap(_small_steps(cpu, torch.float64, bench,
                                               model_type, lr, perm), host)
                        for perm in SMALL_PERMS]
                tail += (f"; second loss card against CPU "
                         f"{_loss_gap(card, host):.2e} apart (limit "
                         f"{ADAM_RATE_LOSS_RTOL:g}), the CPU against itself "
                         f"with the classes permuted "
                         f"{', '.join(f'{g:.2e}' for g in gaps)}")
            log(f"[small] card against CPU, {what}: float64 losses card "
                f"{card['losses']} cpu {host['losses']}, {tail}")


def _profiled_step(train_step, state, batch, kernels=None):
    """One train step under ``torch.profiler``: (its wall ms, the device's
    busy ms in it); ``kernels``, where given, receives the device us by
    kernel name."""
    from torch.profiler import ProfilerActivity, profile

    from multimodal_clinical_tpu_torch.benchmarks.profile_vggsound import (
        kernel_times,
    )

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, _ = train_step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    times = kernel_times(prof)
    busy = sum(times.values()) / 1e3
    if kernels is not None:
        kernels.update(times)
    if not 0 < busy <= wall:
        raise AssertionError(f"device busy {busy:.3f} ms in {wall:.3f} ms: "
                             "the trace's kernel times are wrong")
    return wall, busy


def _drive_small_type(device, card: str, bench: str, model_type: str):
    """One warm-up step (a padded tail: the QMF History must change at the
    real idx only), SMALL_TIMED timed steps and one eval step of
    ``bench``'s ``model_type`` at the published geometry and the config's
    compute dtype; then one profiled step.  Returns the step median."""
    from multimodal_clinical_tpu_torch.engine.steps import (
        make_eval_step, make_train_step,
    )

    table = MIMIC_TRAIN if bench == "mimic" else SMALL_BATCH * 4
    torch.cuda.reset_peak_memory_stats()
    spec, state, args = _small_state(bench, model_type, device, table)
    batches = _small_batches(bench, device, SMALL_BATCH,
                             (SMALL_BATCH_VALID, SMALL_BATCH), table)
    train_step, eval_step = make_train_step(spec), make_eval_step(spec)
    tables = None
    if state.qmf_correctness is not None:
        tables = (state.qmf_correctness.clone(), state.qmf_confidence.clone())
    losses, step_ms = [], []
    for i in range(1 + SMALL_TIMED):
        t = time.perf_counter()
        state, metrics = train_step(state, batches[min(i, 1)])
        torch.cuda.synchronize()
        if i:
            step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(metrics["train_loss"]))
        if i == 0 and tables is not None:
            real = torch.unique(batches[0]["idx"][batches[0]["valid"] > 0])
            changed = ((state.qmf_correctness != tables[0])
                       | (state.qmf_confidence != tables[1])).any(dim=0)
            if not torch.equal(torch.nonzero(changed)[:, 0], real):
                raise AssertionError(f"{bench} {model_type}: the History "
                                     "changed away from the real idx")
    out = eval_step(state, batches[1])
    wall, busy = _profiled_step(train_step, state, batches[1])
    classes = SMALL_BENCHES[bench][0]
    n = spec.num_modality
    if not all(math.isfinite(x) for x in losses) or out[
            "logits_stack"].shape != (SMALL_BATCH, n, classes) or not bool(
            torch.isfinite(out["logits_stack"]).all()):
        raise AssertionError(f"{bench} {model_type}: losses {losses}, eval "
                             f"{tuple(out['logits_stack'].shape)}")
    median = statistics.median(step_ms)
    # the profiler slows the host, not the kernels: the device's busy time
    # is read from the profiled step, its share of the unprofiled median
    idle = 1 - busy / median
    if not 0 <= idle < 1:
        raise AssertionError(f"{bench} {model_type}: device busy {busy:.3f} "
                             f"ms in a {median:.3f} ms median step")
    log(f"[{bench} {model_type}] {card}: {getattr(args, 'compute_dtype')} "
        f"{type(state.optimizer).__name__}, train step median {median:.3f} "
        f"ms over {SMALL_TIMED} ({min(step_ms):.3f}-{max(step_ms):.3f}); "
        f"{SMALL_BATCH / median * 1e3:.1f} samples/s at batch "
        f"{SMALL_BATCH}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; one profiled "
        f"step {wall:.3f} ms, device busy {busy:.3f} ms in it, idle share "
        f"{idle:.3f} of the median step; warm-up loss {losses[0]:.5f}, eval "
        f"loss {float(out['loss']):.5f}"
        + (" (History written at the real idx only)" if tables else ""))
    SINGLE_STEP_MS[(bench, model_type)] = median
    return median


def _small_cli_runs(device, bench: str, work: Path, model_type=None,
                    others=None, data_path=None, process=None):
    """Phase 17c (and 19c, 20d) for one benchmark: the CLI on the twin (or
    on the files at ``data_path``) for two epochs in ``model_type`` (by
    default SMALL_CLI's; as ``python3 -m multimodal_clinical_tpu_torch
    --dir <bench>`` where ``process``, by default for SMALL_CLI_PROCESS,
    else its ``run_training`` in process), ``--resume`` for a third in
    process (the restored optimizer state, EMA and QMF tables equal the
    saved ones), then each of ``others`` (by default every other model
    type) for one epoch in process."""
    import importlib

    from multimodal_clinical_tpu_torch import __main__ as cli
    from multimodal_clinical_tpu_torch.engine import run

    module = importlib.import_module(
        f"multimodal_clinical_tpu_torch.benchmarks.{bench}")
    model_type = model_type or SMALL_CLI[bench]
    others = [t for t in (others or module.MODEL_TYPES) if t != model_type]
    root = work / bench
    data_path = data_path or f"{root}/none"
    base = ["--set", f"ckpt_dir={root}", "--set", f"data_path={data_path}"]
    argv = base + ["--set", f"model_type={model_type}", "--set",
                   "num_epochs=2"]
    if process is None:
        process = bench == SMALL_CLI_PROCESS
    if process:
        out = _cli(argv, bench=bench)
        summary = ast.literal_eval(out.strip().splitlines()[-1])
    else:
        summary = cli.run_training(["--dir", bench, *argv], device=device)
    if not math.isfinite(summary.get("test_epoch/test_avg_acc", math.nan)):
        raise AssertionError(f"{bench}: summary {summary}")
    (ckpt,) = root.glob("*/ckpt")
    last = max(ckpt.glob("last-*"), key=lambda p: int(p.name.split("-")[1]))
    saved = torch.load(last / "state.pt", map_location="cpu",
                       weights_only=True)
    restored = {}

    class Watched(run.Trainer):
        def resume(self):
            found = super().resume()
            st = self.state
            restored.update(
                step=st.step, ema=st.ema.cpu().clone(),
                optimizer={i: {n: v.cpu().clone() for n, v in s.items()
                               if torch.is_tensor(v)}
                           for i, s in st.optimizer.state_dict()[
                               "state"].items()},
                tables=[None if t is None else t.cpu().clone()
                        for t in (st.qmf_correctness, st.qmf_confidence)])
            return found

    trainer_cls, run.Trainer = run.Trainer, Watched
    try:
        t = time.perf_counter()
        cli.run_training(["--dir", bench, *base, "--set",
                          f"model_type={model_type}", "--set",
                          "num_epochs=3", "--resume"], device=device)
        wall = time.perf_counter() - t
    finally:
        run.Trainer = trainer_cls
    same = (restored.get("step") == saved["step"]
            and torch.equal(restored["ema"], saved["ema"].cpu()))
    for i, kept in saved["optimizer"]["state"].items():
        for n, v in kept.items():
            if torch.is_tensor(v):
                same = same and torch.equal(restored["optimizer"][i][n],
                                            v.cpu())
    for got, want in zip(restored["tables"], (saved["qmf_correctness"],
                                              saved["qmf_confidence"])):
        same = same and ((got is None and want is None)
                         or torch.equal(got, want.cpu()))
    meta = json.loads((ckpt / "meta.json").read_text())
    if not same or meta["epochs_done"] != 3:
        raise AssertionError(f"{bench} --resume did not restore the saved "
                             f"state (meta {meta})")
    kinds = sorted({n for s in saved["optimizer"]["state"].values()
                    for n, v in s.items() if torch.is_tensor(v)
                    and v.dim() > 0})
    log(f"[cli] {bench} {model_type} --resume in process ({wall:.1f} s): "
        f"restored step {saved['step']}, the EMA, the optimizer's {kinds}"
        + (" and the History" if saved["qmf_correctness"] is not None
           else "") + "; three epochs done")
    for other in others:
        t = time.perf_counter()
        summary = cli.run_training(
            ["--dir", bench, "--set", f"ckpt_dir={root / other}", "--set",
             f"data_path={data_path}", "--set", f"model_type={other}",
             "--set", "num_epochs=1"], device=device)
        if not math.isfinite(summary.get("test_epoch/test_avg_acc",
                                         math.nan)):
            raise AssertionError(f"{bench} {other}: summary {summary}")
        names = sorted(p.name for p in (root / other).glob("*/ckpt/*"))
        log(f"[cli] {bench} {other} one epoch in process "
            f"({time.perf_counter() - t:.1f} s): test_avg_acc "
            f"{summary['test_epoch/test_avg_acc']:.4f}, checkpoints {names}")


def _small_files_run(device, bench: str, work: Path):
    """Phase 17d for one benchmark: the fixture's files in the reference's
    layout, read by ``get_data`` for one CLI epoch in process."""
    from multimodal_clinical_tpu_torch import __main__ as cli
    from multimodal_clinical_tpu_torch.benchmarks import array_fixture as fx

    root = work / f"{bench}_files"
    t = time.perf_counter()
    if bench == "avmnist":
        made = fx.build_avmnist_tree(str(root), *SMALL_FILES[bench])
        path = root
    elif bench == "mimic":
        path = root / "im.pk"
        made = fx.build_mimic_pickle(str(path), SMALL_FILES[bench])
    else:
        path = root / "sarcasm.pkl"
        made = fx.build_mustard_pickle(str(path), *SMALL_FILES[bench])
    written = time.perf_counter() - t
    t = time.perf_counter()
    summary = cli.run_training(
        ["--dir", bench, "--set", f"ckpt_dir={root}/runs", "--set",
         f"data_path={path}", "--set", "num_epochs=1"], device=device)
    if not math.isfinite(summary.get("test_epoch/test_avg_acc", math.nan)):
        raise AssertionError(f"{bench} files: summary {summary}")
    rows = [json.loads(line) for p in root.glob("runs/*/metrics.jsonl")
            for line in p.read_text().splitlines()]
    epoch = next(r for r in rows if r.get("epoch") == 0)
    log(f"[files] {bench}: {made['rows']} rows, {made['bytes'] / 1e6:.1f} "
        f"MB written in {written:.1f} s; one CLI epoch through get_data in "
        f"{time.perf_counter() - t:.1f} s "
        f"({epoch['train_epoch/samples_per_sec']:.1f} train samples/s over "
        f"the epoch), test_avg_acc "
        f"{summary['test_epoch/test_avg_acc']:.4f}")
    shutil.rmtree(root, ignore_errors=True)


def phase_small_benchmarks(device, card: str, kernels):
    """Phase 17: AV-MNIST, MIMIC and MUsTARD.  (a) card against CPU; then
    per benchmark, its launch counts set to 0 first and read last: (b)
    every model type at the published geometry, (c) the CLI on the twin
    with ``--resume`` and every other model type for one epoch, (d) the
    fixture's files through ``get_data`` for one CLI epoch.  No TPU
    kernel lies on these paths: each must record 0 launches."""
    import importlib

    t0 = time.perf_counter()
    phase_small_card_against_cpu(device)
    log(f"[small] 17a took {time.perf_counter() - t0:.1f} s")
    work = WORK_DIR / "small"
    shutil.rmtree(work, ignore_errors=True)
    launchers = {**_all_launchers(), **_probe_launchers()}
    # 17b-d at the settings the CLI starts with, not the TF32-off ones of
    # the comparisons
    log(f"[small] 17b-d at (matmul TF32, cuDNN TF32, CPU threads) "
        f"{TORCH_DEFAULTS}")
    try:
        with _torch_set(*TORCH_DEFAULTS):
            for bench in SMALL_BENCHES:
                module = importlib.import_module(
                    f"multimodal_clinical_tpu_torch.benchmarks.{bench}")
                for fn in launchers.values():
                    fn.launches = 0
                t = time.perf_counter()
                for model_type in module.MODEL_TYPES:
                    _drive_small_type(device, card, bench, model_type)
                    torch.cuda.empty_cache()
                _small_cli_runs(device, bench, work)
                _small_files_run(device, bench, work)
                launches = {name: fn.launches
                            for name, fn in launchers.items()}
                if any(launches.values()):
                    raise AssertionError(f"{bench}: TPU kernels launched on "
                                         f"its path: {launches}")
                for entry in kernels:
                    entry.setdefault("launches_by_path", {})[bench] = (
                        launches[entry["name"]])
                log(f"[small] {bench}: 17b-d took "
                    f"{time.perf_counter() - t:.1f} s; launches of every TPU "
                    f"kernel on its path: {launches}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[small] phase 17 took {time.perf_counter() - t0:.1f} s")


# -- phase 18: Enrico and FakeNews --------------------------------------------

# 18a: card against CPU, two steps of WIDE_ROWS rows (the second with
# WIDE_VALID real ones) from the same weights, narrow nets at small inputs:
# (benchmark, model type, net built from the spec's arguments, the inputs'
# kinds); "u8" uint8 pixels, "unit" floats in [0, 1], "ids" token rows
# padded at their tail (the second row all padding), else normal floats
WIDE_ROWS, WIDE_VALID = 6, 4
WIDE_CASES = (
    ("enrico", "jlogits", [("u8", (64, 32, 3))] * 2),
    ("enrico", "jlogits_counts", [("u8", (64, 32, 3))] * 2),
    ("fakenews", "jlogits_dialogue",
     [("ids", 24), ("unit", (64, 64, 3)), ("ids", 24)]),
    ("fakenews", "jlogits_embed",
     [("normal", (768,)), ("normal", (64, 64, 3))]),
)
# 18b: the published geometry, nothing cut: Enrico's 256 x 128 uint8
# screenshots and wireframes at batch 64 over 20 topics (configs/
# enrico.yaml, enrico/get_data.py:94-103); FakeNews's 128 tokens over the
# bert-base-uncased vocabulary and 224 x 224 images at batch 32 over the 6
# ways (configs/fakenews.yaml), the embed variants' 768-d embeddings and
# torchvision resnet152 at 224 (fakenews/model.py:27,238)
WIDE_BENCHES = {
    "enrico": (20, 64, [("u8", (256, 128, 3))] * 2),
    "fakenews": (6, 32, [("ids", 128), ("unit", (224, 224, 3)),
                         ("ids", 128)]),
    "fakenews_embed": (6, 32, [("normal", (768,)), ("normal", (224, 224, 3)),
                               ("normal", (768,))]),
}
WIDE_TIMED = 3
# 18c: the disk corpora, cut in rows only: Enrico's screens as RICO
# captures them (1440 x 2560 JPEG screenshots, PNG wireframes; 1460 screens
# in the real CSV), FakeNews's posts with 640 x 480 JPEGs (~1M real)
WIDE_DISK_ENRICO = 128
WIDE_DISK_FAKENEWS = (96, 32, 32)
WIDE_DIR = WORK_DIR / "wide"


def _wide_batches(bench_kinds, classes: int, dev, rows: int, valid,
                  seed: int = 0, dtype=None):
    """Train batches of ``rows`` from numpy's ``seed`` generator, one per
    entry of ``valid`` (its count of real rows; the rest repeat the last
    real one); float inputs cast to ``dtype`` where given, as the Loader
    casts them for a bf16 net."""
    rng = np.random.default_rng(seed)
    out = []
    for real in valid:
        pick = np.arange(rows).clip(max=real - 1)
        batch = {}
        for i, (kind, shape) in enumerate(bench_kinds):
            if kind == "u8":
                x = rng.integers(0, 256, (rows,) + shape, dtype=np.uint8)
            elif kind == "ids":
                x = rng.integers(1, 30522, (rows, shape)).astype(np.int32)
                length = rng.integers(1, shape + 1, rows)
                length[1] = 0  # a row of padding only
                x[np.arange(shape) >= length[:, None]] = 0
            elif kind == "unit":
                x = rng.random((rows,) + shape, dtype=np.float32)
            else:
                x = rng.standard_normal((rows,) + shape, dtype=np.float32)
            batch[f"x{i + 1}"] = x[pick]
        batch["label"] = rng.integers(0, classes, rows)[pick]
        batch["valid"] = (np.arange(rows) < real).astype(np.float32)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in batch.items()}
        if dtype is not None:
            batch = {k: v.to(dtype) if k.startswith("x")
                     and v.is_floating_point() else v
                     for k, v in batch.items()}
        out.append(batch)
    return out


def _wide_spec(bench: str, model_type: str, narrow: bool = False,
               **overrides):
    """(benchmark module, spec, optimizer arguments, args) of ``bench``'s
    ``model_type`` from its config.  ``narrow``: the towers of 18a (ResNets
    at width 16, one Bottleneck block a stage; the VGG and text towers
    as they are)."""
    import dataclasses
    import importlib

    from multimodal_clinical_tpu_torch.config import load_config
    from multimodal_clinical_tpu_torch.models import zoo

    module = importlib.import_module(
        f"multimodal_clinical_tpu_torch.benchmarks.{bench}")
    if narrow and "embed" in model_type:
        overrides["embed_stage_sizes"] = (1, 1, 1, 1)
    args = load_config(bench, overrides=dict(model_type=model_type,
                                             **overrides))
    spec, opt = module.get_model_spec(args, n_train=64)
    if narrow and bench == "enrico" and model_type == "jlogits":
        spec = dataclasses.replace(spec, module=zoo.EnricoFusionNet(
            int(args.num_classes), True, None, width=16))
    elif narrow and bench == "fakenews" and "embed" not in model_type:
        spec = dataclasses.replace(spec, module=zoo.FakeNewsFusionNet(
            int(args.num_classes), with_dialogue=True, width=16))
    return module, spec, opt, args


def _injected_dropout(step: int):
    """A mask source for one train step: the i-th dropout reached draws
    from numpy's (step, i) generator on the CPU and moves to the device,
    so card and CPU drop the same entries."""
    count = [0]

    def source(shape, keep_prob, device):
        rng = np.random.default_rng((step, count[0]))
        count[0] += 1
        return torch.from_numpy(rng.random(shape) < keep_prob).to(device)

    return source


def _wide_steps(dev, dtype, bench: str, model_type: str, kinds,
                **overrides):
    """Two train steps of a narrow 18a (or 20a) net in fp32 compute
    (``dtype`` the parameters' and inputs'; ``overrides`` config keys), in
    the keys of ``_small_steps``; frozen parameters have no gradient and
    no optimizer state."""
    from multimodal_clinical_tpu_torch.engine.state import create_train_state
    from multimodal_clinical_tpu_torch.engine.steps import make_train_step

    _, spec, opt, args = _wide_spec(bench, model_type, narrow=True,
                                    compute_dtype="float32", **overrides)
    state = create_train_state(spec, args, 0, steps_per_epoch=100,
                               device=dev, **opt)
    state.model.to(dtype)
    cpu = lambda t: t.detach().cpu().clone()
    init = {k: cpu(v) for k, v in state.model.state_dict().items()}
    step = make_train_step(
        spec, dropout=lambda st: _injected_dropout(st.step))
    named = dict(state.model.named_parameters())
    losses, grads = [], []
    for batch in _wide_batches(kinds, int(args.num_classes), dev, WIDE_ROWS,
                               (WIDE_ROWS, WIDE_VALID)):
        # float64: uint8 pixels as the preprocess's / 255 in float64
        batch = {k: (v.to(dtype) / 255.0 if v.dtype == torch.uint8
                     and dtype == torch.float64 else v.to(dtype))
                 if k.startswith("x") and (v.is_floating_point()
                                           or v.dtype == torch.uint8)
                 else v for k, v in batch.items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["train_loss"]))
        grads.append({k: cpu(p.grad) for k, p in named.items()
                      if p.grad is not None})
    moments = {k: {n: cpu(v) for n, v in state.optimizer.state[p].items()
                   if torch.is_tensor(v) and v.shape == p.shape}
               for k, p in named.items()}
    frozen = [k for k in named if k.startswith(spec.frozen_prefixes)]
    return dict(losses=losses, init=init, grads=grads, moments=moments,
                final={k: cpu(v) for k, v in state.model.state_dict().items()},
                ema=cpu(state.ema), frozen=frozen,
                lr=state.optimizer.param_groups[0]["lr"],
                adam=isinstance(state.optimizer, torch.optim.Adam))


def phase_wide_card_against_cpu(device):
    """Phase 18a: Enrico jlogits (frozen ResNet18Slim features) and
    jlogits_counts (frozen VGG11Slim stacks, 16 dropouts injected), FakeNews
    jlogits_dialogue (two text towers over rows with padded tails and one
    of padding only) and jlogits_embed (one Bottleneck block a stage, its
    fusion dropout injected), two train steps on the card and on the CPU
    from the same weights: fp32 (TF32 off) losses, BN buffers and EMA;
    float64 updates and optimizer state (``_compare_f64_small_steps``);
    the frozen leaves bit-unchanged on both devices with no optimizer
    state."""
    cpu = torch.device("cpu")
    with _torch_set(False, False, 2):
        for bench, model_type, kinds in WIDE_CASES:
            what = f"{bench} {model_type}"
            card, host = (
                _wide_steps(device, torch.float32, bench, model_type, kinds),
                _wide_steps(cpu, torch.float32, bench, model_type, kinds))
            _compare_fp32_steps(card, host, what)
            card, host = (
                _wide_steps(device, torch.float64, bench, model_type, kinds),
                _wide_steps(cpu, torch.float64, bench, model_type, kinds))
            for run in (card, host):
                for key in run["frozen"]:
                    if not (torch.equal(run["final"][key], run["init"][key])
                            and not run["moments"][key]):
                        raise AssertionError(f"{what}: frozen {key} moved")
            tail = _compare_f64_small_steps(card, host, what,
                                            rounding=(".key.bias",))
            log(f"[wide] card against CPU, {what}: float64 losses card "
                f"{card['losses']} cpu {host['losses']}, {tail}; "
                f"{len(card['frozen'])} frozen leaves bit-unchanged")


def _drive_wide_type(device, card: str, bench: str, model_type: str):
    """One warm-up step (a padded tail), WIDE_TIMED timed steps and one
    eval step of ``model_type`` at the published geometry in the config's
    dtype, then one profiled step; frozen leaves bit-unchanged after.
    Returns the step median."""
    from multimodal_clinical_tpu_torch.engine.state import create_train_state
    from multimodal_clinical_tpu_torch.engine.steps import (
        make_eval_step, make_train_step,
    )

    key = "fakenews_embed" if "embed" in model_type else bench
    classes, batch, kinds = WIDE_BENCHES[key]
    n_in = 3 if model_type.endswith("dialogue") else 2
    torch.cuda.reset_peak_memory_stats()
    _, spec, opt, args = _wide_spec(bench, model_type)
    state = create_train_state(spec, args, 0, steps_per_epoch=100,
                               device=device, **opt)
    named = dict(state.model.named_parameters())
    frozen = {k: p.detach().clone() for k, p in named.items()
              if k.startswith(spec.frozen_prefixes)}
    batches = _wide_batches(kinds[:n_in], classes, device, batch,
                            (batch - 4, batch), dtype=torch.bfloat16)
    train_step, eval_step = make_train_step(spec), make_eval_step(spec)
    losses, step_ms = [], []
    for i in range(1 + WIDE_TIMED):
        t = time.perf_counter()
        state, metrics = train_step(state, batches[min(i, 1)])
        torch.cuda.synchronize()
        if i:
            step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(metrics["train_loss"]))
    out = eval_step(state, batches[1])
    wall, busy = _profiled_step(train_step, state, batches[1])
    moved = [k for k, v in frozen.items() if not torch.equal(named[k], v)
             or state.optimizer.state[named[k]]]
    n = spec.num_modality
    if moved or not all(math.isfinite(x) for x in losses) or out[
            "logits_stack"].shape != (batch, n, classes) or not bool(
            torch.isfinite(out["logits_stack"]).all()):
        raise AssertionError(f"{bench} {model_type}: losses {losses}, eval "
                             f"{tuple(out['logits_stack'].shape)}, frozen "
                             f"leaves moved {moved[:3]}")
    median = statistics.median(step_ms)
    idle = 1 - busy / median
    if not 0 <= idle < 1:
        raise AssertionError(f"{bench} {model_type}: device busy {busy:.3f} "
                             f"ms in a {median:.3f} ms median step")
    log(f"[{bench} {model_type}] {card}: {args.compute_dtype} "
        f"{type(state.optimizer).__name__} at lr "
        f"{state.optimizer.param_groups[0]['lr']:g}, train step median "
        f"{median:.3f} ms over {WIDE_TIMED} ({min(step_ms):.3f}-"
        f"{max(step_ms):.3f}); {batch / median * 1e3:.1f} samples/s at "
        f"batch {batch}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; one profiled "
        f"step {wall:.3f} ms, device busy {busy:.3f} ms in it, idle share "
        f"{idle:.3f} of the median step; warm-up loss {losses[0]:.5f}, eval "
        f"loss {float(out['loss']):.5f}; {len(frozen)} frozen leaves "
        "bit-unchanged")
    return median


def _torchvision_layout(encoder, extra_fc: int, seed: int):
    """``encoder``'s state_dict redrawn from ``seed`` (running variances
    in [0.5, 2]) with torchvision's extra ``fc`` and
    ``num_batches_tracked`` entries: what a local torchvision checkpoint
    holds."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for key, value in encoder.state_dict().items():
        value = value.detach().cpu()
        if "running_var" in key:
            sd[key] = torch.rand(value.shape, generator=gen) * 1.5 + 0.5
        else:
            sd[key] = torch.randn(value.shape, generator=gen) * 0.05
    sd["fc.weight"] = torch.randn(1000, extra_fc, generator=gen)
    sd["fc.bias"] = torch.zeros(1000)
    sd["bn1.num_batches_tracked"] = torch.tensor(0)
    return sd


def _check_load_pretrained(device, work: Path):
    """Seeded torchvision-layout resnet18 and resnet152 state dicts
    through ``load_pretrained`` (Enrico's ``torchvision_weights``, the
    embed variant's ``resnet152_weights``): the eval logits equal those of
    the same nets with the weights loaded straight into the towers."""
    from multimodal_clinical_tpu_torch.engine.state import create_train_state

    work.mkdir(parents=True, exist_ok=True)
    for bench, model_type, key, towers in (
            ("enrico", "jlogits", "torchvision_weights",
             ("x1_model.features", "x2_model.features")),
            ("fakenews", "jlogits_embed", "resnet152_weights",
             ("image_module",))):
        module, spec, opt, args = _wide_spec(bench, model_type)
        state = create_train_state(spec, args, 0, steps_per_epoch=10,
                                   device=device, **opt)
        sd = _torchvision_layout(state.model.get_submodule(towers[0]),
                                 512 if bench == "enrico" else 2048, 11)
        path = work / f"{key}.pth"
        torch.save(sd, path)
        direct = {k: v.clone() for k, v in state.model.state_dict().items()}
        for tower in towers:
            for name in state.model.get_submodule(tower).state_dict():
                direct[f"{tower}.{name}"] = sd[name].to(device)
        setattr(args, key, str(path))
        state = module.load_pretrained(args, state)
        key_ = "fakenews_embed" if "embed" in model_type else bench
        classes, _, kinds = WIDE_BENCHES[key_]
        (batch,) = _wide_batches(kinds[:2], classes, device, 4, (4,),
                                 dtype=torch.bfloat16)
        from multimodal_clinical_tpu_torch.engine.steps import make_eval_step

        got = make_eval_step(spec)(state, batch)["logits_stack"]
        state.model.load_state_dict(direct)
        want = make_eval_step(spec)(state, batch)["logits_stack"]
        if not torch.equal(got, want):
            raise AssertionError(f"{bench} {key}: logits differ")
        log(f"[wide] {bench} {key}: a seeded torchvision-layout state_dict "
            f"({len(sd)} entries) through load_pretrained gives the logits "
            "of the towers loaded directly")


def _wide_cli(device, bench: str, root: Path, model_type: str, epochs: int,
              *extra):
    """``__main__.run_training`` for ``--dir bench`` in process: its
    summary and wall seconds."""
    from multimodal_clinical_tpu_torch import __main__ as cli

    t = time.perf_counter()
    summary = cli.run_training(
        ["--dir", bench, "--set", f"ckpt_dir={root}", "--set",
         f"model_type={model_type}", "--set", f"num_epochs={epochs}",
         *extra], device=device)
    if not math.isfinite(summary.get("test_epoch/test_avg_acc", math.nan)):
        raise AssertionError(f"{bench} {model_type}: summary {summary}")
    return summary, time.perf_counter() - t


def _wide_cli_runs(device, work: Path):
    """Phase 18c: the Enrico and FakeNews CLIs on their twins for two
    epochs and ``--resume`` for a third (the restored optimizer state and
    EMA equal the saved ones); then on disk corpora in the reference's
    layouts: Enrico, FakeNews's TSVs (WordPiece over the corpus's
    vocab.txt) and the embed variant's dialogue dataframes, one epoch
    each."""
    from multimodal_clinical_tpu_torch.benchmarks import disk_fixture
    from multimodal_clinical_tpu_torch.engine import run

    for bench in ("enrico", "fakenews"):
        root = work / bench
        twin = ("--set", f"data_path={root}/none")
        _, wall = _wide_cli(device, bench, root, "jlogits", 2, *twin)
        (ckpt,) = root.glob("*/ckpt")
        last = max(ckpt.glob("last-*"),
                   key=lambda p: int(p.name.split("-")[1]))
        saved = torch.load(last / "state.pt", map_location="cpu",
                           weights_only=True)
        restored = {}

        class Watched(run.Trainer):
            def resume(self):
                found = super().resume()
                st = self.state
                restored.update(
                    step=st.step, ema=st.ema.cpu().clone(),
                    optimizer={i: {n: v.cpu().clone() for n, v in s.items()
                                   if torch.is_tensor(v)}
                               for i, s in st.optimizer.state_dict()[
                                   "state"].items()})
                return found

        trainer_cls, run.Trainer = run.Trainer, Watched
        try:
            _, resumed = _wide_cli(device, bench, root, "jlogits", 3,
                                   "--resume", *twin)
        finally:
            run.Trainer = trainer_cls
        same = (restored.get("step") == saved["step"]
                and torch.equal(restored["ema"], saved["ema"].cpu())
                and restored["optimizer"].keys()
                == saved["optimizer"]["state"].keys())
        for i, kept in saved["optimizer"]["state"].items():
            for n, v in kept.items():
                if torch.is_tensor(v):
                    same = same and torch.equal(restored["optimizer"][i][n],
                                                v.cpu())
        meta = json.loads((ckpt / "meta.json").read_text())
        if not same or meta["epochs_done"] != 3:
            raise AssertionError(f"{bench} --resume did not restore the "
                                 f"saved state (meta {meta})")
        log(f"[cli] {bench} jlogits on the twin: two epochs {wall:.1f} s, "
            f"--resume for a third {resumed:.1f} s (restored step "
            f"{saved['step']}, the EMA and the optimizer state of "
            f"{len(saved['optimizer']['state'])} parameters)")
    t = time.perf_counter()
    enrico_tree = work / "enrico_disk"
    made = disk_fixture.build_enrico_tree(str(enrico_tree), WIDE_DISK_ENRICO,
                                          size=(1440, 2560), distinct=8)
    fake_tree = work / "fakenews_disk"
    made_fn = disk_fixture.build_fakenews_tree(
        str(fake_tree), *WIDE_DISK_FAKENEWS, size=(640, 480), distinct=16)
    from multimodal_clinical_tpu_torch.utils import native

    log(f"[disk] Enrico {made['screens']} screens ({made['bytes'] / 1e6:.1f} "
        f"MB) and FakeNews {made_fn['rows']} posts "
        f"({made_fn['bytes'] / 1e6:.1f} MB) written in "
        f"{time.perf_counter() - t:.1f} s; the screenshots decode through "
        + ("native libjpeg" if native.available() else "PIL"))
    for bench, tree, model_type in (
            ("enrico", enrico_tree, "jlogits"),
            ("fakenews", fake_tree, "jlogits"),
            ("fakenews", fake_tree, "jlogits_embed_dialogue")):
        summary, wall = _wide_cli(device, bench, work / f"{bench}_runs",
                                  model_type, 1, "--set",
                                  f"data_path={tree}/")
        rows = [json.loads(line)
                for p in (work / f"{bench}_runs").glob("*/metrics.jsonl")
                for line in p.read_text().splitlines()]
        epoch = [r for r in rows if r.get("epoch") == 0][-1]
        log(f"[disk] {bench} {model_type}: one CLI epoch through get_data "
            f"in {wall:.1f} s ({epoch['train_epoch/samples_per_sec']:.1f} "
            f"train samples/s over the epoch), test_avg_acc "
            f"{summary['test_epoch/test_avg_acc']:.4f}")
        shutil.rmtree(work / f"{bench}_runs", ignore_errors=True)


def phase_wide_benchmarks(device, card: str, kernels):
    """Phase 18: Enrico and FakeNews.  (a) card against CPU; then, their
    launch counts set to 0 first and read last: (b) every model type at the
    published geometry, and ``load_pretrained`` from torchvision-layout
    files, (c) the CLIs on the twins with ``--resume`` and on disk
    corpora.  No TPU kernel lies on these paths: each must record 0
    launches."""
    import importlib

    t0 = time.perf_counter()
    phase_wide_card_against_cpu(device)
    log(f"[wide] 18a took {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(WIDE_DIR, ignore_errors=True)
    launchers = {**_all_launchers(), **_probe_launchers()}
    log(f"[wide] 18b-c at (matmul TF32, cuDNN TF32, CPU threads) "
        f"{TORCH_DEFAULTS}")
    try:
        with _torch_set(*TORCH_DEFAULTS):
            for fn in launchers.values():
                fn.launches = 0
            t = time.perf_counter()
            for bench in ("enrico", "fakenews"):
                module = importlib.import_module(
                    f"multimodal_clinical_tpu_torch.benchmarks.{bench}")
                for model_type in module.MODEL_TYPES:
                    _drive_wide_type(device, card, bench, model_type)
                    torch.cuda.empty_cache()
            _check_load_pretrained(device, WIDE_DIR / "weights")
            log(f"[wide] 18b took {time.perf_counter() - t:.1f} s")
            t = time.perf_counter()
            _wide_cli_runs(device, WIDE_DIR)
            log(f"[wide] 18c took {time.perf_counter() - t:.1f} s")
            launches = {name: fn.launches for name, fn in launchers.items()}
            if any(launches.values()):
                raise AssertionError("TPU kernels launched on the Enrico and "
                                     f"FakeNews paths: {launches}")
            for entry in kernels:
                for bench in ("enrico", "fakenews"):
                    entry.setdefault("launches_by_path", {})[bench] = (
                        launches[entry["name"]])
            log(f"[wide] launches of every TPU kernel on the Enrico and "
                f"FakeNews paths: {launches}")
    finally:
        shutil.rmtree(WIDE_DIR, ignore_errors=True)
    log(f"[wide] phase 18 took {time.perf_counter() - t0:.1f} s")


# -- phase 19: Food101's SigLIP family ----------------------------------------

FOOD_TYPES = ("jlogits", "ensemble", "ogm_ge", "qmf")
# 19a: tests/test_siglip_parity.py's tiny SigLIP; two steps of 6 rows, the
# second with 4 real ones, from a History of 12 rows
FOOD_NARROW = dict(width=64, layers=2, heads=2, mlp_dim=128, patch=16,
                   image_size=32, text_len=16, vocab=1000)
FOOD_ROWS, FOOD_VALID, FOOD_TABLE = 6, 4, 12
# 19b: the published geometry, nothing cut (configs/food101.yaml,
# models/siglip.py): siglip-base-patch16-224 in bf16 at batch 128 over 101
# classes, the twin's 64 ids and 224 x 224 x 3 pixels; the warm-up batch
# with 4 padded rows
FOOD_BATCH, FOOD_PAD, FOOD_TIMED = 128, 4, 5
# kernels listed from jlogits' profiled step
FOOD_TOP = 10
# 19d: the corpus, cut in rows only (train, dev, test)
FOOD_DISK = (256, 32, 32)
# 19e: the seeded checkpoint's towers in fp32 (TF32 off), card against
# CPU: the same products summed in another order through 12 blocks
FOOD_LOAD_TOL = 1e-4
FOOD_DIR = WORK_DIR / "food101"


@contextlib.contextmanager
def _narrow_food():
    """``Food101FusionNet`` builds the FOOD_NARROW SigLIP while open (it
    looks ``SigLIPModel`` up in ``models/siglip.py`` when built)."""
    import functools

    from multimodal_clinical_tpu_torch.models import siglip

    wide = siglip.SigLIPModel
    siglip.SigLIPModel = functools.partial(wide, **FOOD_NARROW)
    try:
        yield
    finally:
        siglip.SigLIPModel = wide


def _food_spec(model_type: str, n_train: int, **overrides):
    """(spec, optimizer arguments, args) of ``model_type`` from
    configs/food101.yaml."""
    from multimodal_clinical_tpu_torch.benchmarks import food101
    from multimodal_clinical_tpu_torch.config import load_config

    args = load_config("food101", overrides=dict(model_type=model_type,
                                                 **overrides))
    spec, opt = food101.get_model_spec(args, n_train=n_train)
    return spec, opt, args


def _food_batches(dev, valid, seed: int = 0):
    """FOOD_ROWS-row batches of the narrow net, one per entry of ``valid``
    (its count of real rows; the rest repeat the last real one, ``idx``
    included): ids below the vocabulary, pixels in [-1, 1]."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(FOOD_TABLE)
    size, length = FOOD_NARROW["image_size"], FOOD_NARROW["text_len"]
    out = []
    for step, real in enumerate(valid):
        pick = np.arange(FOOD_ROWS).clip(max=real - 1)
        batch = {
            "x1": rng.integers(0, FOOD_NARROW["vocab"], (FOOD_ROWS, length)),
            "x2": rng.uniform(-1, 1, (FOOD_ROWS, size, size, 3)),
            "label": rng.integers(0, 101, FOOD_ROWS),
            "idx": order[step * FOOD_ROWS:(step + 1) * FOOD_ROWS]}
        batch = {k: v[pick] for k, v in batch.items()}
        batch["valid"] = (np.arange(FOOD_ROWS) < real).astype(np.float32)
        out.append({k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                    for k, v in batch.items()})
    return out


def _food_steps(dev, dtype, model_type: str):
    """Two train steps of the narrow net in fp32 compute (``dtype`` the
    parameters' and pixels'), the heads' dropout masks drawn on the CPU
    for both devices; in the keys of ``_small_steps``, with the QMF
    tables."""
    from multimodal_clinical_tpu_torch.engine.state import create_train_state
    from multimodal_clinical_tpu_torch.engine.steps import make_train_step

    with _narrow_food():
        spec, opt, args = _food_spec(model_type, FOOD_TABLE,
                                     compute_dtype="float32")
    state = create_train_state(spec, args, 0, steps_per_epoch=100,
                               device=dev, **opt)
    state.model.to(dtype)
    cpu = lambda t: t.detach().cpu().clone()
    init = {k: cpu(v) for k, v in state.model.state_dict().items()}
    step = make_train_step(
        spec, dropout=lambda st: _injected_dropout(st.step))
    named = dict(state.model.named_parameters())
    losses, grads = [], []
    for batch in _food_batches(dev, (FOOD_ROWS, FOOD_VALID)):
        batch["x2"] = batch["x2"].to(dtype)
        state, metrics = step(state, batch)
        losses.append(float(metrics["train_loss"]))
        grads.append({k: cpu(p.grad) for k, p in named.items()})
    moments = {k: {n: cpu(v) for n, v in state.optimizer.state[p].items()
                   if torch.is_tensor(v) and v.shape == p.shape}
               for k, p in named.items()}
    tables = (None if state.qmf_correctness is None else
              (cpu(state.qmf_correctness), cpu(state.qmf_confidence)))
    return dict(losses=losses, init=init, grads=grads, moments=moments,
                final={k: cpu(v) for k, v in state.model.state_dict().items()},
                ema=cpu(state.ema), tables=tables,
                lr=state.optimizer.param_groups[0]["lr"], adam=False)


def phase_food_card_against_cpu(device):
    """Phase 19a: the narrow Food101 net under each SigLIP model type, two
    train steps on the card and on the CPU from the same weights, inputs
    and dropout masks, TF32 off: losses, EMA and QMF tables in fp32;
    updates and momentum in float64 (``_compare_f64_small_steps``; the key
    projections' biases, whose gradient is zero in exact arithmetic, held
    to rounding)."""
    cpu = torch.device("cpu")
    with _torch_set(False, False, 2):
        for model_type in FOOD_TYPES:
            what = f"food101 {model_type}"
            card, host = (_food_steps(device, torch.float32, model_type),
                          _food_steps(cpu, torch.float32, model_type))
            _compare_fp32_steps(card, host, what)
            seen = _food_batches("cpu", (FOOD_ROWS, FOOD_VALID))
            tables = _check_tables(card, host, CPU_TABLE_RTOL,
                                   CPU_TABLE_ATOL, what, seen)
            card, host = (_food_steps(device, torch.float64, model_type),
                          _food_steps(cpu, torch.float64, model_type))
            tail = _compare_f64_small_steps(card, host, what,
                                            rounding=(".k_proj.bias",))
            tail += "; float64 " + _check_tables(
                card, host, F64_TABLE_RTOL, F64_TABLE_ATOL, what, seen)
            log(f"[food101] card against CPU, {what}: fp32 {tables}; "
                f"float64 losses card {card['losses']} cpu "
                f"{host['losses']}, {tail}")


def _food_full_batches(dataset, device):
    """The twin's first FOOD_BATCH rows, once with FOOD_PAD padded rows
    (repeating the last real one, ``idx`` included) and once whole, the
    pixels cast to bf16 as the Loader casts them for the bf16 net."""
    out = []
    for real in (FOOD_BATCH - FOOD_PAD, FOOD_BATCH):
        idx = np.arange(FOOD_BATCH).clip(max=real - 1)
        batch = dataset.gather(idx)
        batch["idx"] = idx.astype(np.int32)
        batch["valid"] = (np.arange(FOOD_BATCH) < real).astype(np.float32)
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        batch["x2"] = batch["x2"].to(torch.bfloat16)
        out.append(batch)
    return out


def _drive_food_type(device, card: str, model_type: str, data):
    """One warm-up step (a padded tail: the QMF History must change at the
    real idx only; under ogm_ge the modulation must leave every gradient
    bit-unchanged), FOOD_TIMED timed steps and one eval step of
    ``model_type`` at the published geometry in bf16, then one profiled
    step.  Returns the step median."""
    from multimodal_clinical_tpu_torch.engine import steps
    from multimodal_clinical_tpu_torch.engine.state import create_train_state

    torch.cuda.reset_peak_memory_stats()
    spec, opt, args = _food_spec(model_type, len(data.train))
    state = create_train_state(spec, args, 0, steps_per_epoch=100,
                               device=device, **opt)
    batches = _food_full_batches(data.train, device)
    train_step = steps.make_train_step(spec)
    eval_step = steps.make_eval_step(spec)
    tables = (None if state.qmf_correctness is None
              else state.qmf_correctness.clone())
    modulated = []

    def unchanged_by_modulation(model, *args, **kwargs):
        before = {n: p.grad.clone() for n, p in model.named_parameters()}
        modulate(model, *args, **kwargs)
        modulated.append(all(torch.equal(p.grad, before[n])
                             for n, p in model.named_parameters()))

    modulate, steps.modulate_gradients = (steps.modulate_gradients,
                                          unchanged_by_modulation)
    try:
        state, metrics = train_step(state, batches[0])
    finally:
        steps.modulate_gradients = modulate
    if modulated != ([True] if model_type == "ogm_ge" else []):
        raise AssertionError(f"food101 {model_type}: modulation changed a "
                             f"gradient or did not run ({modulated})")
    if tables is not None:
        changed = np.flatnonzero((state.qmf_correctness != tables).any(
            dim=0).cpu().numpy())
        if not np.array_equal(changed, np.arange(FOOD_BATCH - FOOD_PAD)):
            raise AssertionError(f"food101 qmf: History changed at {changed}")
    losses, step_ms = [float(metrics["train_loss"])], []
    for _ in range(FOOD_TIMED):
        t = time.perf_counter()
        state, metrics = train_step(state, batches[1])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(metrics["train_loss"]))
    out = eval_step(state, batches[1])
    kernels = {}
    wall, busy = _profiled_step(train_step, state, batches[1], kernels)
    if model_type == "jlogits":
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:FOOD_TOP]
        log(f"[food101 jlogits] the profiled step's {len(kernels)} kernels, "
            f"the {FOOD_TOP} largest (device ms): " + "; ".join(
                f"{name[:72]} {us / 1e3:.3f}" for name, us in top))
    if not all(math.isfinite(x) for x in losses) or out[
            "logits_stack"].shape != (FOOD_BATCH, 2, 101) or not bool(
            torch.isfinite(out["logits_stack"]).all()):
        raise AssertionError(f"food101 {model_type}: losses {losses}, eval "
                             f"{tuple(out['logits_stack'].shape)}")
    median = statistics.median(step_ms)
    idle = 1 - busy / median
    if not 0 <= idle < 1:
        raise AssertionError(f"food101 {model_type}: device busy {busy:.3f} "
                             f"ms in a {median:.3f} ms median step")
    n_params = sum(p.numel() for p in state.model.parameters())
    log(f"[food101 {model_type}] {card}: {args.compute_dtype} SGD at lr "
        f"{state.optimizer.param_groups[0]['lr']:g}, {n_params} parameters; "
        f"train step median {median:.3f} ms over {FOOD_TIMED} "
        f"({min(step_ms):.3f}-{max(step_ms):.3f}); "
        f"{FOOD_BATCH / median * 1e3:.1f} samples/s at batch {FOOD_BATCH}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
        f"one profiled step {wall:.3f} ms, device busy {busy:.3f} ms in it, "
        f"idle share {idle:.3f} of the median step; warm-up loss "
        f"{losses[0]:.5f}, eval loss {float(out['loss']):.5f}"
        + ("; the modulation left every gradient bit-unchanged"
           if model_type == "ogm_ge" else ""))
    return median


def _food_load_pretrained(device, data):
    """Phase 19e: a seeded siglip-base HF-layout ``model.safetensors``
    (``logit_scale`` and ``logit_bias`` included), written by the
    ``safetensors`` package, through ``load_pretrained``'s
    ``siglip_weights`` (the port's own reader): the towers hold it bit for
    bit and the heads are untouched; then the towers loaded from it in
    fp32 (TF32 off), their forward on the card against the CPU."""
    from safetensors.torch import save_file

    from multimodal_clinical_tpu_torch.benchmarks import food101
    from multimodal_clinical_tpu_torch.engine.state import create_train_state
    from multimodal_clinical_tpu_torch.models import siglip

    spec, opt, args = _food_spec("qmf", len(data.train))
    state = create_train_state(spec, args, 0, steps_per_epoch=10,
                               device=device, **opt)
    gen = torch.Generator().manual_seed(13)
    sd = {}
    for key, value in state.model.model.state_dict().items():
        noise = torch.randn(value.shape, generator=gen) * 0.02
        sd[key] = noise + 1.0 if "norm" in key and key.endswith(
            "weight") else noise
    sd["logit_scale"], sd["logit_bias"] = torch.ones(1), -torch.ones(1)
    where = FOOD_DIR / "siglip"
    where.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    save_file(sd, str(where / "model.safetensors"))
    size = (where / "model.safetensors").stat().st_size
    head = state.model.x1_model.mlp[0].weight.clone()
    args.siglip_weights = str(where)
    state = food101.load_pretrained(args, state)
    loaded = time.perf_counter() - t
    got = state.model.model.state_dict()
    if any(not torch.equal(got[k].cpu(), sd[k]) for k in got) or not (
            torch.equal(state.model.x1_model.mlp[0].weight, head)):
        raise AssertionError("food101 siglip_weights: the towers do not hold "
                             "the file, or a head moved")
    batch = data.train.gather(np.arange(2))
    ids, pixels = (torch.from_numpy(batch[k]) for k in ("x1", "x2"))
    outs = []
    with _torch_set(False, False, TORCH_DEFAULTS[2]), torch.no_grad():
        for dev in (device, torch.device("cpu")):
            towers = siglip.load_hf_siglip_params(
                str(where), siglip.SigLIPModel()).to(dev)
            outs.append([o.cpu() for o in towers(ids.to(dev),
                                                 pixels.to(dev))])
    errs = [_scaled_err(c, h) for c, h in zip(*outs)]
    if not max(errs) <= FOOD_LOAD_TOL:
        raise AssertionError(f"food101 siglip_weights: towers card against "
                             f"CPU {errs}")
    log(f"[food101] siglip_weights: a seeded siglip-base model.safetensors "
        f"({size / 1e6:.1f} MB, {len(sd)} entries) written and loaded in "
        f"{loaded:.1f} s; the towers hold it bit for bit; their fp32 "
        f"forward on the card against the CPU: text {errs[0]:.2e}, image "
        f"{errs[1]:.2e} of the largest entry (limit {FOOD_LOAD_TOL:g})")


def _food_disk(device):
    """Phase 19d: a corpus of FOOD_DISK rows through ``get_data``: the
    first train batch on the card against its gather, then one CLI epoch
    of qmf on it."""
    from multimodal_clinical_tpu_torch.benchmarks import disk_fixture, food101
    from multimodal_clinical_tpu_torch.config import load_config
    from multimodal_clinical_tpu_torch.engine import run

    tree = FOOD_DIR / "disk"
    t = time.perf_counter()
    made = disk_fixture.build_food101_tree(str(tree), *FOOD_DISK)
    log(f"[disk] Food101 {made['rows']} samples ({made['bytes'] / 1e6:.1f} "
        f"MB of .npy) written in {time.perf_counter() - t:.1f} s")
    args = load_config("food101", overrides=dict(data_path=f"{tree}/"))
    data = food101.get_data(args)
    if data.synthetic or not isinstance(data.train,
                                        food101.Food101DiskDataset):
        raise AssertionError("food101 get_data did not read the corpus")
    _check_first_batch(run.build_loaders(args, data, device)[0], data.train,
                       "Food101")
    runs = FOOD_DIR / "disk_runs"
    summary, wall = _wide_cli(device, "food101", runs, "qmf", 1, "--set",
                              f"data_path={tree}/")
    rows = [json.loads(line) for p in runs.glob("*/metrics.jsonl")
            for line in p.read_text().splitlines()]
    epoch = [r for r in rows if r.get("epoch") == 0][-1]
    log(f"[disk] food101 qmf: one CLI epoch through get_data in {wall:.1f} s "
        f"({epoch['train_epoch/samples_per_sec']:.1f} train samples/s over "
        f"the epoch), test_avg_acc {summary['test_epoch/test_avg_acc']:.4f}")


def phase_food101(device, card: str, kernels):
    """Phase 19: Food101's SigLIP family.  (a) card against CPU; then, the
    launch counts set to 0 first and read last: (b) each model type at the
    published geometry, (e) ``load_pretrained`` from a seeded
    ``model.safetensors``, (c) the CLI on the twin with ``--resume`` and
    the other types, (d) the disk corpus.  No TPU kernel lies on this
    path: each must record 0 launches."""
    from multimodal_clinical_tpu_torch.benchmarks import food101
    from multimodal_clinical_tpu_torch.config import load_config

    t0 = time.perf_counter()
    phase_food_card_against_cpu(device)
    log(f"[food101] 19a took {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(FOOD_DIR, ignore_errors=True)
    launchers = {**_all_launchers(), **_probe_launchers()}
    try:
        with _torch_set(*TORCH_DEFAULTS):
            for fn in launchers.values():
                fn.launches = 0
            t = time.perf_counter()
            data = food101.get_data(load_config("food101", overrides=dict(
                data_path=str(FOOD_DIR / "none"))))
            for model_type in FOOD_TYPES:
                _drive_food_type(device, card, model_type, data)
                torch.cuda.empty_cache()
            _food_load_pretrained(device, data)
            torch.cuda.empty_cache()
            log(f"[food101] 19b and 19e took {time.perf_counter() - t:.1f} s")
            t = time.perf_counter()
            _small_cli_runs(device, "food101", FOOD_DIR, model_type="qmf",
                            others=FOOD_TYPES)
            log(f"[food101] 19c took {time.perf_counter() - t:.1f} s")
            t = time.perf_counter()
            _food_disk(device)
            log(f"[food101] 19d took {time.perf_counter() - t:.1f} s")
            launches = {name: fn.launches for name, fn in launchers.items()}
            if any(launches.values()):
                raise AssertionError("TPU kernels launched on the Food101 "
                                     f"path: {launches}")
            for entry in kernels:
                entry.setdefault("launches_by_path", {})["food101"] = (
                    launches[entry["name"]])
            log(f"[food101] launches of every TPU kernel on the Food101 "
                f"path: {launches}")
    finally:
        shutil.rmtree(FOOD_DIR, ignore_errors=True)
    log(f"[food101] phase 19 took {time.perf_counter() - t0:.1f} s")


# -- phase 20: Food101's legacy pair -----------------------------------------

LEGACY_TYPES = ("jprobas", "jprobas_jlogits")
# 20a: the towers of tests/test_food101_legacy.py through the config's
# keys (a two-stage ResNet, two 32-wide BERT layers of 4 heads over the
# full vocabulary), two steps of WIDE_ROWS rows of 32 x 32 images and 16
# ids (padded tails, a row of padding only)
LEGACY_NARROW = dict(legacy_stages=[1, 1], legacy_bert_layers=2,
                     legacy_bert_width=32, legacy_bert_heads=4)
LEGACY_NARROW_KINDS = [("normal", (32, 32, 3)), ("ids", 16)]
# 20b: the published geometry, nothing cut (configs/food101.yaml,
# data/food101_legacy.py): torchvision resnet50 and bert-base-uncased in
# bf16 at batch 128 over 101 classes, 224 x 224 x 3 ImageNet-normalised
# images and 512 ids padded with 0; the warm-up batch with 4 padded rows
LEGACY_KINDS = [("normal", (224, 224, 3)), ("ids", 512)]
LEGACY_BATCH, LEGACY_PAD, LEGACY_TIMED = 128, 4, 5
# 20c: the seeded checkpoints' towers in fp32 (TF32 off), card against CPU:
# the same products summed in another order through 12 layers or 16 blocks
LEGACY_LOAD_TOL = 1e-4
# 20d: the corpus, cut in rows only (train, test; UPMC Food-101 has ~67 000
# and ~22 700), its JPEGs at Food-101's 512 pixels a side
LEGACY_DISK = (256, 64)
LEGACY_IMAGE = (512, 384)
LEGACY_DIR = WORK_DIR / "food101_legacy"


def phase_legacy_card_against_cpu(device):
    """Phase 20a: the narrow legacy net under jprobas and jprobas_jlogits,
    two train steps on the card and on the CPU from the same weights,
    inputs and dropout masks (BERT's seven a step, the attention weights'
    included), TF32 off: fp32 losses, BN buffers and EMA; float64 updates
    and momentum of the two heads; the frozen towers bit-unchanged on both
    devices with no optimizer state."""
    cpu = torch.device("cpu")
    with _torch_set(False, False, 2):
        for model_type in LEGACY_TYPES:
            what = f"food101 {model_type}"
            card, host = (_wide_steps(dev, dtype, "food101", model_type,
                                      LEGACY_NARROW_KINDS, **LEGACY_NARROW)
                          for dev, dtype in ((device, torch.float32),
                                             (cpu, torch.float32)))
            _compare_fp32_steps(card, host, what)
            card, host = (_wide_steps(dev, dtype, "food101", model_type,
                                      LEGACY_NARROW_KINDS, **LEGACY_NARROW)
                          for dev, dtype in ((device, torch.float64),
                                             (cpu, torch.float64)))
            for run in (card, host):
                for key in run["frozen"]:
                    if not (torch.equal(run["final"][key], run["init"][key])
                            and not run["moments"][key]):
                        raise AssertionError(f"{what}: frozen {key} moved")
            tail = _compare_f64_small_steps(card, host, what)
            log(f"[legacy] card against CPU, {what}: float64 losses card "
                f"{card['losses']} cpu {host['losses']}, {tail}; "
                f"{len(card['frozen'])} frozen leaves bit-unchanged")


def _drive_legacy_type(device, card: str, model_type: str, batches):
    """One warm-up step (a padded tail) and one more, after which every
    frozen parameter must be bit-unchanged and every BN running statistic
    of the ResNet50 moved; LEGACY_TIMED timed steps, one eval step and one
    profiled step of ``model_type`` at the published geometry in bf16."""
    from multimodal_clinical_tpu_torch.engine import steps
    from multimodal_clinical_tpu_torch.engine.state import create_train_state

    torch.cuda.reset_peak_memory_stats()
    _, spec, opt, args = _wide_spec("food101", model_type)
    state = create_train_state(spec, args, 0, steps_per_epoch=100,
                               device=device, **opt)
    sd = state.model.state_dict()
    frozen = {k: v.clone() for k, v in state.model.named_parameters()
              if k.startswith(spec.frozen_prefixes)}
    stats = {k: v.clone() for k, v in sd.items() if "running" in k}
    train_step = steps.make_train_step(spec)
    eval_step = steps.make_eval_step(spec)
    losses = []
    for batch in batches:
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["train_loss"]))
    moved = [k for k, v in frozen.items() if not torch.equal(sd[k], v)]
    still = [k for k, v in stats.items() if torch.equal(sd[k], v)]
    if moved or still or not frozen or not stats:
        raise AssertionError(f"food101 {model_type}: frozen leaves moved "
                             f"{moved[:3]}, BN statistics unmoved {still[:3]}")
    step_ms = []
    for _ in range(LEGACY_TIMED):
        t = time.perf_counter()
        state, metrics = train_step(state, batches[1])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(metrics["train_loss"]))
    out = eval_step(state, batches[1])
    kernels = {}
    wall, busy = _profiled_step(train_step, state, batches[1], kernels)
    if model_type == LEGACY_TYPES[0]:
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:FOOD_TOP]
        log(f"[legacy {model_type}] the profiled step's {len(kernels)} "
            f"kernels, the {FOOD_TOP} largest (device ms): " + "; ".join(
                f"{name[:72]} {us / 1e3:.3f}" for name, us in top))
    if not all(math.isfinite(x) for x in losses) or out[
            "logits_stack"].shape != (LEGACY_BATCH, 2, 101) or not bool(
            torch.isfinite(out["logits_stack"]).all()):
        raise AssertionError(f"food101 {model_type}: losses {losses}, eval "
                             f"{tuple(out['logits_stack'].shape)}")
    median = statistics.median(step_ms)
    idle = 1 - busy / median
    if not 0 <= idle < 1:
        raise AssertionError(f"food101 {model_type}: device busy {busy:.3f} "
                             f"ms in a {median:.3f} ms median step")
    n_params = sum(p.numel() for p in state.model.parameters())
    log(f"[legacy {model_type}] {card}: {args.compute_dtype} SGD at lr "
        f"{state.optimizer.param_groups[0]['lr']:g}, {n_params} parameters "
        f"({sum(v.numel() for v in frozen.values())} frozen, bit-unchanged "
        f"after two steps; {len(stats)} BN running statistics moved); train "
        f"step median {median:.3f} ms over {LEGACY_TIMED} "
        f"({min(step_ms):.3f}-{max(step_ms):.3f}); "
        f"{LEGACY_BATCH / median * 1e3:.1f} samples/s at batch "
        f"{LEGACY_BATCH}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; one profiled "
        f"step {wall:.3f} ms, device busy {busy:.3f} ms in it, idle share "
        f"{idle:.3f} of the median step; warm-up loss {losses[0]:.5f}, eval "
        f"loss {float(out['loss']):.5f}")
    return median


def _legacy_load_pretrained(device):
    """Phase 20c: a seeded torchvision-named resnet50 ``.pth`` (its ``fc``
    and ``num_batches_tracked`` included) and an HF-named bert-base
    ``model.safetensors`` (under ``bert.``, with the pooler and a token
    classifier), written by torch and the ``safetensors`` package, through
    ``load_pretrained``: the towers hold them bit for bit and the heads are
    untouched; then the towers loaded from them in fp32 (TF32 off), their
    forward on the card against the CPU."""
    from safetensors.torch import save_file

    from multimodal_clinical_tpu_torch.benchmarks import food101
    from multimodal_clinical_tpu_torch.engine.state import create_train_state
    from multimodal_clinical_tpu_torch.models import bert, zoo
    from multimodal_clinical_tpu_torch.models.pretrained import (
        copy_by_name, torch_state_dict,
    )

    _, spec, opt, args = _wide_spec("food101", "jprobas")
    state = create_train_state(spec, args, 0, steps_per_epoch=10,
                               device=device, **opt)
    gen = torch.Generator().manual_seed(17)

    def seeded(module, prefix=""):
        out = {}
        for key, value in module.state_dict().items():
            noise = torch.randn(value.shape, generator=gen) * 0.02
            out[prefix + key] = (noise.abs() + 1.0 if key.endswith(
                ("running_var", "LayerNorm.weight")) else noise)
        return out

    r50 = seeded(state.model.x1_model.features)
    r50.update({k.replace("running_var", "num_batches_tracked"):
                torch.tensor(1000) for k in list(r50)
                if k.endswith("running_var")})
    r50["fc.weight"], r50["fc.bias"] = torch.randn(1000, 2048), torch.zeros(
        1000)
    hf = seeded(state.model.x2_model.model, "bert.")
    hf.update({"bert.pooler.dense.weight": torch.randn(768, 768),
               "bert.pooler.dense.bias": torch.zeros(768),
               "classifier.weight": torch.randn(9, 768),
               "classifier.bias": torch.zeros(9)})
    LEGACY_DIR.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    torch.save(r50, LEGACY_DIR / "resnet50.pth")
    where = LEGACY_DIR / "bert"
    where.mkdir(exist_ok=True)
    save_file(hf, str(where / "model.safetensors"))
    sizes = [(LEGACY_DIR / "resnet50.pth").stat().st_size,
             (where / "model.safetensors").stat().st_size]
    heads = [state.model.x1_model.fc.weight.clone(),
             state.model.x2_model.classifier.weight.clone()]
    args.resnet50_weights, args.bert_weights = (
        str(LEGACY_DIR / "resnet50.pth"), str(where))
    state = food101.load_pretrained(args, state)
    loaded = time.perf_counter() - t
    got = state.model.state_dict()
    held = all(torch.equal(got["x1_model.features." + k].cpu(), r50[k])
               for k in state.model.x1_model.features.state_dict())
    held = held and all(
        torch.equal(got["x2_model.model." + k].cpu(), hf["bert." + k])
        for k in state.model.x2_model.model.state_dict())
    if not held or not (torch.equal(state.model.x1_model.fc.weight, heads[0])
                        and torch.equal(state.model.x2_model.classifier.weight,
                                        heads[1])):
        raise AssertionError("food101 resnet50_weights/bert_weights: the "
                             "towers do not hold the files, or a head moved")
    del state
    torch.cuda.empty_cache()
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.standard_normal((2, 224, 224, 3),
                                                  dtype=np.float32))
    ids = torch.from_numpy(rng.integers(1, 30522, (2, 512)))
    ids[0, 40:] = 0
    outs = []
    with _torch_set(False, False, TORCH_DEFAULTS[2]), torch.no_grad():
        for dev in (device, torch.device("cpu")):
            net = zoo.Food101LegacyFusionNet(101).eval()
            copy_by_name(torch_state_dict(args.resnet50_weights),
                         net.x1_model.features)
            bert.load_hf_bert_params(args.bert_weights, net.x2_model.model)
            net.to(dev)
            outs.append([net.x1_model.features(images.to(dev)).cpu(),
                         net.x2_model.model(ids.to(dev)).cpu()])
    errs = [_scaled_err(c, h) for c, h in zip(*outs)]
    if not max(errs) <= LEGACY_LOAD_TOL:
        raise AssertionError(f"food101 legacy weights: towers card against "
                             f"CPU {errs}")
    log(f"[legacy] resnet50_weights and bert_weights: a seeded resnet50 "
        f".pth ({sizes[0] / 1e6:.1f} MB, {len(r50)} entries) and bert-base "
        f"model.safetensors ({sizes[1] / 1e6:.1f} MB, {len(hf)} entries) "
        f"written and loaded in {loaded:.1f} s; the towers hold them bit for "
        f"bit, the heads untouched; their fp32 forward on the card against "
        f"the CPU: ResNet50 {errs[0]:.2e}, BERT {errs[1]:.2e} of the largest "
        f"entry (limit {LEGACY_LOAD_TOL:g})")


def _legacy_disk(device):
    """Phase 20d: a ``build_food101_legacy_tree`` corpus of LEGACY_DISK
    rows through ``get_data``: the first train batch on the card against
    its gather; ``python3 -m multimodal_clinical_tpu_torch --dir food101
    --set model_type=jprobas_jlogits`` on it for two epochs, ``--resume``
    for a third in process, and jprobas for one epoch in process."""
    from multimodal_clinical_tpu_torch.benchmarks import disk_fixture, food101
    from multimodal_clinical_tpu_torch.config import load_config
    from multimodal_clinical_tpu_torch.data.food101_legacy import (
        Food101LegacyDiskDataset,
    )
    from multimodal_clinical_tpu_torch.engine import run

    tree = LEGACY_DIR / "disk"
    t = time.perf_counter()
    made = disk_fixture.build_food101_legacy_tree(
        str(tree), *LEGACY_DISK, size=LEGACY_IMAGE)
    log(f"[disk] Food101 legacy {made['rows']} samples ({made['bytes'] / 1e6:.1f} "
        f"MB of JPEGs of {LEGACY_IMAGE[0]} x {LEGACY_IMAGE[1]}) written in "
        f"{time.perf_counter() - t:.1f} s")
    args = load_config("food101", overrides=dict(
        data_path=f"{tree}/", model_type="jprobas_jlogits"))
    data = food101.get_data(args)
    if data.synthetic or not isinstance(data.train,
                                        Food101LegacyDiskDataset):
        raise AssertionError("food101 legacy get_data did not read the "
                             "corpus")
    _check_first_batch(run.build_loaders(args, data, device)[0], data.train,
                       "Food101 legacy")
    _small_cli_runs(device, "food101", LEGACY_DIR,
                    model_type="jprobas_jlogits", others=LEGACY_TYPES,
                    data_path=f"{tree}/", process=True)


def phase_food101_legacy(device, card: str, kernels):
    """Phase 20: Food101's legacy pair.  (a) card against CPU; then, the
    launch counts set to 0 first and read last: (b) each model type at the
    published geometry, (c) ``load_pretrained`` from seeded checkpoints,
    (d) the CLI on a disk corpus with ``--resume``.  No TPU kernel lies on
    this path: each must record 0 launches."""
    t0 = time.perf_counter()
    phase_legacy_card_against_cpu(device)
    log(f"[legacy] 20a took {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(LEGACY_DIR, ignore_errors=True)
    launchers = {**_all_launchers(), **_probe_launchers()}
    try:
        with _torch_set(*TORCH_DEFAULTS):
            for fn in launchers.values():
                fn.launches = 0
            t = time.perf_counter()
            batches = _wide_batches(LEGACY_KINDS, 101, device, LEGACY_BATCH,
                                    (LEGACY_BATCH - LEGACY_PAD, LEGACY_BATCH),
                                    dtype=torch.bfloat16)
            for model_type in LEGACY_TYPES:
                _drive_legacy_type(device, card, model_type, batches)
                torch.cuda.empty_cache()
            del batches
            log(f"[legacy] 20b took {time.perf_counter() - t:.1f} s")
            t = time.perf_counter()
            _legacy_load_pretrained(device)
            torch.cuda.empty_cache()
            log(f"[legacy] 20c took {time.perf_counter() - t:.1f} s")
            t = time.perf_counter()
            _legacy_disk(device)
            log(f"[legacy] 20d took {time.perf_counter() - t:.1f} s")
            launches = {name: fn.launches for name, fn in launchers.items()}
            if any(launches.values()):
                raise AssertionError("TPU kernels launched on the Food101 "
                                     f"legacy path: {launches}")
            for entry in kernels:
                entry.setdefault("launches_by_path", {})["food101_legacy"] = (
                    launches[entry["name"]])
            log(f"[legacy] launches of every TPU kernel on the Food101 legacy "
                f"path: {launches}")
    finally:
        shutil.rmtree(LEGACY_DIR, ignore_errors=True)
    log(f"[legacy] phase 20 took {time.perf_counter() - t0:.1f} s")


# -- phase 21: the multi-seed sweep ------------------------------------------

# 21a: S seeds on the card against the same sweep on the CPU and against S
# single-seed runs on the card, fp32 with TF32 off, two train steps (the
# second with a padded tail) on per-seed data.  Crema-D's narrow net (width
# 8, one block a stage, the stored-index stem pool; with and without the
# BN-sums BN) under every contract, seed s on numpy's seed 3 + 10 s data
# (phase 13's batches; tests/test_torch_port_multiseed_step.py holds the
# same geometry on the CPU); MIMIC's nets under SGD and Adam; the
# reference's dropout heads (``HeadMLP``) on MIMIC's inputs, MIMIC's own
# nets having no dropout.  OGM-GE noise and dropout masks are drawn on the
# CPU per (seed, step) and given to both devices.  The quantities held are
# those of phase 13's fp32 comparison: losses, BN buffers, EMA and QMF
# tables, to its limits (two fp32 sums of the same terms in another
# order), the buffers to SWEEP_BUFFER_TOL
SWEEP_SEEDS = (0, 1, 2)
SWEEP_CONTRACTS = ("jlogits", "jprobas", "ensemble", "ogm_ge", "qmf")
SWEEP_SMALL = (("mimic", "jlogits"), ("mimic", "jprobas"),
               ("heads", "jlogits"), ("heads", "qmf"))
SWEEP_DATA_SEED = 3
# BN buffers after the second step carry the first update's fp32 gradient
# rounding (phase 6: updates are not compared in fp32), which train-mode BN
# over layer4's few values per channel amplifies: each stacked buffer is
# held to this share of its largest entry
SWEEP_BUFFER_TOL = 1e-4
# 21b: (benchmark, model type, seeds) at the config's geometry through the
# CLI in process, two epochs on the twins (VGGSound on waveforms, as phase
# 12); then, on the last batch and state of each, SWEEP_TIMED timed steps
# after a warm-up and one profiled step
SWEEP_RUNS = (("mimic", "jlogits", 20), ("mimic", "ensemble", 20),
              ("avmnist", "jlogits", 8), ("cremad", "ogm_ge", 4),
              ("vggsound", "jprobas", 2))
SWEEP_TIMED = 3
SWEEP_DIR = WORK_DIR / "multiseed"
# the single-seed train step's median in ms by (benchmark, model type), as
# phases 7 (VGGSound jprobas), 14 (Crema-D ogm_ge with the stored-index
# pool) and 17b (AV-MNIST and MIMIC) measured it in this run
SINGLE_STEP_MS = {}


class _DropoutHeads(torch.nn.Module):
    """The reference's dropout head (``models/mlp.py::HeadMLP``: Linear,
    ReLU, Dropout(0.2), Linear, ReLU, Dropout(0.2), Linear) on each of
    MIMIC's two inputs."""

    def __init__(self, classes: int):
        from multimodal_clinical_tpu_torch.models.mlp import HeadMLP

        super().__init__()
        self.x1_model = HeadMLP(classes, 5, hidden_dim=16)
        self.x2_model = HeadMLP(classes, 24 * 12, hidden_dim=16)

    def forward(self, x1, x2):
        return {"logits": [self.x1_model(x1), self.x2_model(x2.flatten(1))]}


def _sweep_case(bench: str, model_type: str, bn_fused: bool = False):
    """(spec, args, optimizer arguments) of a 21a case, its net fresh."""
    import dataclasses
    import functools
    import importlib

    from multimodal_clinical_tpu_torch.models import zoo

    args = SimpleNamespace(num_classes=6, batch_size=CONTRACT_ROWS,
                           learning_rate=1e-2, num_epochs=60,
                           use_scheduler=False, seed=0, model_type=model_type,
                           alpha=0.8, grad_mod_type="OGM_GE")
    module = importlib.import_module(
        "multimodal_clinical_tpu_torch.benchmarks."
        + ("cremad" if bench == "cremad" else "mimic"))
    spec, opt = module.get_model_spec(args, n_train=CONTRACT_TABLE)
    if bench == "cremad":
        encoder = zoo.ResNetEncoder
        zoo.ResNetEncoder = functools.partial(
            encoder, stage_sizes=(1, 1, 1, 1), bn_fused=bn_fused)
        try:
            net = zoo.CremadFusionNet(6, width=8, pool_kernel="pallas")
        finally:
            zoo.ResNetEncoder = encoder
        spec = dataclasses.replace(spec, module=net)
    elif bench == "heads":
        spec = dataclasses.replace(spec, module=_DropoutHeads(6))
    return spec, args, opt


def _sweep_batches(bench: str, dev, seed_pos: int):
    seed = SWEEP_DATA_SEED + 10 * seed_pos
    if bench == "cremad":
        return _contract_batches(dev, seed)
    return _small_batches("mimic", dev, CONTRACT_ROWS,
                          (CONTRACT_ROWS, CONTRACT_VALID), CONTRACT_TABLE,
                          seed)


def _sweep_noise(spec):
    """Per seed, one standard-normal CPU draw per conv weight of the net,
    by name (the same OGM-GE noise on both devices and in both steps)."""
    from multimodal_clinical_tpu_torch.algos.ogm_ge import (
        modulated_parameters,
    )

    out = {}
    for seed in SWEEP_SEEDS:
        gen = torch.Generator().manual_seed(100 + seed)
        out[seed] = {name: torch.randn(p.shape, generator=gen)
                     for _, name, p in modulated_parameters(spec.module)}
    return out


def _cpu_dropout(seed: int, step: int):
    """A mask source drawing on the CPU from (seed, step), moved to the
    activation's device: the same masks on the card and on the CPU."""
    from multimodal_clinical_tpu_torch.engine.state import mixed_seed

    gen = torch.Generator().manual_seed(mixed_seed(seed, step, stream=2))
    return lambda shape, keep_prob, device: (
        torch.rand(shape, generator=gen) < keep_prob).to(device)


def _sweep_result(losses, buffers, ema, tables):
    cpu = lambda t: t.detach().cpu().clone()
    return dict(losses=np.asarray(losses), buffers={
        k: cpu(v) for k, v in buffers.items()}, ema=cpu(ema),
        tables=None if tables[0] is None else tuple(cpu(t) for t in tables))


def _sweep_narrow(dev, bench: str, model_type: str, bn_fused: bool = False):
    """Two sweep steps of a 21a case on ``dev``: losses (steps, S), the
    stacked BN buffers, EMA and QMF tables on the CPU."""
    from multimodal_clinical_tpu_torch.engine.multiseed import (
        create_multiseed_state, make_multiseed_steps,
    )

    spec, args, opt = _sweep_case(bench, model_type, bn_fused)
    noise = _sweep_noise(spec)
    state = create_multiseed_state(spec, args, SWEEP_SEEDS, 100, device=dev,
                                   opt_kwargs=opt)
    step, _ = make_multiseed_steps(
        spec, ogm_noise=lambda seed, _: (
            lambda name, g: noise[seed][name].to(g.device)),
        dropout=_cpu_dropout)
    per_seed = [_sweep_batches(bench, dev, s)
                for s in range(len(SWEEP_SEEDS))]
    losses = []
    for i in range(2):
        state, metrics = step(state, {
            k: torch.stack([b[i][k] for b in per_seed])
            for k in per_seed[0][i]})
        losses.append(metrics["train_loss"].cpu().numpy())
    return _sweep_result(losses, state.buffers, state.ema,
                         (state.qmf_correctness, state.qmf_confidence))


def _singles_narrow(dev, bench: str, model_type: str, bn_fused: bool = False):
    """The same two steps as S single-seed runs on ``dev``, stacked as
    ``_sweep_narrow`` returns them."""
    from multimodal_clinical_tpu_torch.engine.state import create_train_state
    from multimodal_clinical_tpu_torch.engine.steps import make_train_step

    runs = []
    for s, seed in enumerate(SWEEP_SEEDS):
        spec, args, opt = _sweep_case(bench, model_type, bn_fused)
        noise = _sweep_noise(spec)[seed]
        state = create_train_state(spec, args, seed, 100, device=dev, **opt)
        step = make_train_step(
            spec, ogm_noise=lambda _: (
                lambda name, g: noise[name].to(g.device)),
            dropout=lambda st: _cpu_dropout(st.seed, st.step))
        losses = []
        for batch in _sweep_batches(bench, dev, s):
            state, metrics = step(state, batch)
            losses.append(float(metrics["train_loss"]))
        runs.append(_sweep_result(
            losses, dict(state.model.named_buffers()), state.ema,
            (state.qmf_correctness, state.qmf_confidence)))
    stack = lambda ts: torch.stack(list(ts))
    return dict(
        losses=np.stack([r["losses"] for r in runs], axis=1),
        buffers={k: stack(r["buffers"][k] for r in runs)
                 for k in runs[0]["buffers"]},
        ema=stack(r["ema"] for r in runs),
        tables=None if runs[0]["tables"] is None else tuple(
            stack(r["tables"][i] for r in runs) for i in range(2)))


def _compare_sweeps(got, want, what: str) -> str:
    """Losses, EMA and QMF tables to phase 13's fp32 limits, BN buffers to
    SWEEP_BUFFER_TOL; returns the largest differences."""
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=CPU_LOSS_RTOL, err_msg=what)
    worst = 0.0
    for key, ref in want["buffers"].items():
        err = _scaled_err(got["buffers"][key], ref)
        if not err <= SWEEP_BUFFER_TOL:
            raise AssertionError(f"{what} {key}: {err:.3e} of its largest "
                                 "entry apart")
        worst = max(worst, err)
    np.testing.assert_allclose(got["ema"].numpy(), want["ema"].numpy(),
                               rtol=0, atol=CPU_EMA_ATOL, err_msg=what)
    tables = ""
    if want["tables"] is not None:
        for got_t, ref in zip(got["tables"], want["tables"]):
            np.testing.assert_allclose(got_t.numpy(), ref.numpy(),
                                       rtol=CPU_TABLE_RTOL,
                                       atol=CPU_TABLE_ATOL, err_msg=what)
        tables = (f", tables within "
                  f"{_scaled_err(got['tables'][0], want['tables'][0]):.2e}")
    loss_gap = float(np.max(np.abs(got["losses"] - want["losses"])
                            / np.abs(want["losses"])))
    return (f"losses within {loss_gap:.2e}, BN buffers within {worst:.2e}"
            + tables)


def phase_multiseed_card_against_cpu(device):
    """Phase 21a: returns the BN-sums and max-pool launches of the card's
    sweeps (one launch per call for the S seeds: a single-seed run's count
    for one seed)."""
    cpu = torch.device("cpu")
    launchers = _switch_launchers()
    total = collections.Counter()
    cases = ([("cremad", t, fused) for fused in (False, True)
              for t in SWEEP_CONTRACTS]
             + [(b, t, False) for b, t in SWEEP_SMALL])
    with _torch_set(False, False, 2):
        for bench, model_type, fused in cases:
            what = (f"{bench} {model_type}"
                    + (" bn_fused" if fused else "")
                    + (" pool_kernel='pallas'" if bench == "cremad" else ""))
            for fn in launchers.values():
                fn.launches = 0
            with _recording_calls() as calls:
                card = _sweep_narrow(device, bench, model_type, fused)
            # while recording, each launch counts on its recording wrapper
            sweep_launches = {n: len(c) for n, c in calls.items()}
            for fn in launchers.values():
                fn.launches = 0
            singles = _singles_narrow(device, bench, model_type, fused)
            single_launches = {n: fn.launches for n, fn in launchers.items()}
            host = _sweep_narrow(cpu, bench, model_type, fused)
            against_cpu = _compare_sweeps(card, host, f"{what} card vs CPU")
            against_singles = _compare_sweeps(card, singles,
                                              f"{what} sweep vs singles")
            # one launch a call for S seeds; S single runs make S
            for name, count in sweep_launches.items():
                if count * len(SWEEP_SEEDS) != single_launches[name] or (
                        bench == "cremad" and name.startswith("maxpool")
                        and not count) or (fused and not count):
                    raise AssertionError(
                        f"{what}: the sweep launched {sweep_launches}, the "
                        f"single runs {single_launches}")
            total.update(sweep_launches)
            if bench == "cremad":
                _check_path_pools(calls, f"21a {what}")
            for m, c in sorted(set(calls["bn_sums"])):
                _check_bn(*_bn_case(m, c, torch.float32, 5),
                          f"21a {what} ({m}, {c})")
            log(f"[multiseed] 21a {what}, S = {len(SWEEP_SEEDS)}: card "
                f"against CPU {against_cpu}; card sweep against "
                f"{len(SWEEP_SEEDS)} single-seed runs {against_singles}; "
                f"launches {dict(sweep_launches)} (single runs "
                f"{dict(single_launches)})"
                + (f"; BN sums at the folded shapes "
                   f"{sorted(set(calls['bn_sums']))} held" if fused else ""))
    return total


def _sweep_profiled_step(train_step, state, batch):
    """One sweep step under ``torch.profiler``: (its wall ms, the device's
    busy ms as the union of its kernels' intervals, their summed ms, the
    summed ms by kernel family).  The sweep's kernels may overlap (the
    summed time passed the wall time on Crema-D), so busy is the union, not
    ``_profiled_step``'s sum."""
    from torch.profiler import ProfilerActivity, profile

    from multimodal_clinical_tpu_torch.benchmarks.profile_vggsound import (
        family_times, kernel_times,
    )

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        train_step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for start, stop in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    summed = sum(stop - start for start, stop in spans)
    if not 0 < busy / 1e3 <= wall:
        raise AssertionError(f"device busy {busy / 1e3:.3f} ms in {wall:.3f} "
                             "ms: the trace's kernel times are wrong")
    families = {k: v / 1e3 for k, v in
                family_times(kernel_times(prof)).items()}
    return wall, busy / 1e3, summed / 1e3, families


def _check_folded_spectrogram(wave: torch.Tensor) -> None:
    """The log-STFT kernel against its plain version on a superbatch's
    (S, B, samples) waveforms, folded to (S * B, samples) as the sweep's
    preprocess gives them."""
    from multimodal_clinical_tpu_torch.ops import cuda_spectrogram as cs
    from multimodal_clinical_tpu_torch.ops import spectrogram as plain

    wave = wave.flatten(0, 1)
    max_err, clear_err = compare_spectrogram(
        cs.launch_log_spectrogram(wave, 256, 128),
        plain.log_spectrogram(wave, 256, 128))
    log(f"[kernels] log_spectrogram on the sweep's folded waveforms "
        f"{tuple(wave.shape)}: max |log err| {max_err:.3e}, in clear bins "
        f"{clear_err:.3e}")


@contextlib.contextmanager
def _sweep_steps():
    """While open, ``run_multiseed``'s steps count their calls and keep the
    last train call's (step, state, batch)."""
    from multimodal_clinical_tpu_torch.engine import multiseed

    real = multiseed.make_multiseed_steps
    seen = {"train": 0, "eval": 0}

    def make(spec, *args, **kwargs):
        train, evaluate = real(spec, *args, **kwargs)

        def train_step(state, batch):
            seen["train"] += 1
            seen["last"] = (train, state, batch)
            return train(state, batch)

        def eval_step(state, batch):
            seen["eval"] += 1
            return evaluate(state, batch)

        return train_step, eval_step

    multiseed.make_multiseed_steps = make
    try:
        yield seen
    finally:
        multiseed.make_multiseed_steps = real


def _sweep_run(device, bench: str, model_type: str, seeds: int):
    """One 21b sweep of the config's seeds ``seed .. seed + seeds - 1``:
    (summary, seeds.csv rows, calls seen, the seeds)."""
    import dataclasses

    from multimodal_clinical_tpu_torch import __main__ as cli
    from multimodal_clinical_tpu_torch.benchmarks import cremad, vggsound
    from multimodal_clinical_tpu_torch.config import load_config
    from multimodal_clinical_tpu_torch.engine.multiseed import run_multiseed
    from multimodal_clinical_tpu_torch.models.zoo import CremadFusionNet

    root = SWEEP_DIR / f"{bench}_{model_type}"
    sets = dict(model_type=model_type, num_epochs=2, num_seeds=seeds,
                ckpt_dir=str(root), data_path=f"{root}/none")
    with _sweep_steps() as seen:
        if bench in ("mimic", "avmnist"):
            argv = ["--dir", bench]
            for key, value in sets.items():
                argv += ["--set", f"{key}={value}"]
            summary = cli.run_training(argv, device=device)
            group = load_config(bench).group_name
        else:
            # the stored-index pool (Crema-D) and waveform rows (VGGSound,
            # phase 12's) take the CLI's own function with the benchmark's
            # spec and data so changed
            args = load_config(bench, overrides=sets)
            group = args.group_name
            if bench == "cremad":
                module = SimpleNamespace(
                    get_data=cremad.get_data,
                    get_model_spec=lambda a, n_train: (lambda sk: (
                        dataclasses.replace(sk[0], module=CremadFusionNet(
                            int(a.num_classes),
                            dtype=sk[0].module.x1_classifier.dtype,
                            pool_kernel="pallas")), sk[1]))(
                        cremad.get_model_spec(a, n_train)))
            else:
                bundle = _waveform_bundle(2 * BATCH, BATCH)
                module = SimpleNamespace(
                    get_data=lambda _: bundle,
                    get_model_spec=vggsound.get_model_spec)
            summary = run_multiseed(
                args, module, list(range(args.seed, args.seed + seeds)),
                device=device)
    torch.cuda.synchronize()
    rows = (root / group / "seeds.csv").read_text().splitlines()
    first = int(load_config(bench).seed)
    return summary, rows, seen, list(range(first, first + seeds))


def phase_multiseed(device, card: str, kernels):
    """Phase 21: the multi-seed sweep.  (a) narrow nets, card against CPU
    and against single-seed runs; (b) each of SWEEP_RUNS through the CLI at
    the config's geometry, its launch counts set to 0 first and read after;
    (c) per sweep, the step time, the step per seed, the device's idle
    share and peak memory beside the single-seed step of this run's phases
    7, 14 and 17b, and seeds.csv.  vmap's per-sample fallback warning is an
    error throughout."""
    import warnings

    t0 = time.perf_counter()
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error",
                                    message="There is a performance drop")
            narrow = phase_multiseed_card_against_cpu(device)
            log(f"[multiseed] 21a took {time.perf_counter() - t0:.1f} s")
            total, pool_shapes = _multiseed_runs(device, card)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
        shutil.rmtree(SWEEP_DIR, ignore_errors=True)
    for entry in kernels:
        paths = entry.setdefault("launches_by_path", {})
        paths["multiseed"] = total.get(entry["name"], 0)
        if entry["name"] in narrow:
            paths["multiseed_narrow"] = narrow[entry["name"]]
        if entry["name"] in ("maxpool_fwd", "maxpool_bwd"):
            entry.setdefault("checked_shapes_by_path", {})[
                "multiseed"] = pool_shapes
    log(f"[multiseed] launches of every TPU kernel on the sweeps: "
        f"{dict(total)}; in 21a's card sweeps {dict(narrow)}; phase 21 took "
        f"{time.perf_counter() - t0:.1f} s")


def _multiseed_runs(device, card: str):
    """21b and 21c; returns the kernels' launches summed over the runs and
    the max-pool shapes that the Crema-D sweep gave its kernels, at which
    both were held against their plain versions."""
    total = collections.Counter()
    pool_shapes = []
    with _torch_set(*TORCH_DEFAULTS):
        for bench, model_type, seeds in SWEEP_RUNS:
            t = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            with _recording_calls() as calls:
                # while recording, each switched kernel's launches count
                # on its recording wrapper, which _all_launchers gives here
                launchers = _all_launchers()
                for fn in launchers.values():
                    fn.launches = 0
                summary, rows, seen, seed_list = _sweep_run(
                    device, bench, model_type, seeds)
                launches = {n: fn.launches for n, fn in launchers.items()}
            run_s = time.perf_counter() - t
            expected = {}
            if bench == "vggsound":
                # one launch a train and an eval step, for every seed
                expected["log_spectrogram"] = seen["train"] + seen["eval"]
            if bench == "cremad":
                # each tower's stem pool, forward and backward, a train step
                expected["maxpool_fwd"] = expected["maxpool_bwd"] = (
                    2 * seen["train"])
            if launches != {n: expected.get(n, 0) for n in launches}:
                raise AssertionError(f"{bench} {model_type} S={seeds}: "
                                     f"launches {launches}, expected "
                                     f"{expected}")
            total.update(launches)
            header, *body = [r.split(",") for r in rows]
            if ([r[0] for r in body] != [str(s) for s in seed_list]
                    + ["mean", "std"] or header[0] != "seed"
                    or not all(math.isfinite(float(v))
                               for r in body for v in r[1:])
                    or not math.isfinite(summary["test_epoch/test_avg_loss"])):
                raise AssertionError(f"{bench} {model_type}: seeds.csv "
                                     f"{rows[:3]} ..., summary {summary}")
            if bench == "cremad":
                # both kernels at the folded shapes this sweep gave them
                pool_shapes = _check_path_pools(
                    calls, f"21b {bench} {model_type} S={seeds}")
            train, state, batch = seen.pop("last")
            if bench == "vggsound":
                # the kernel against its plain version on the folded
                # (S * B) waveform rows that its sweep launches took
                _check_folded_spectrogram(batch["x1_waveform"])
            step_ms = []
            for i in range(1 + SWEEP_TIMED):
                tic = time.perf_counter()
                state, metrics = train(state, batch)
                torch.cuda.synchronize()
                if i:
                    step_ms.append((time.perf_counter() - tic) * 1e3)
            wall, busy, summed, families = _sweep_profiled_step(
                train, state, batch)
            top = ", ".join(f"{k} {v:.3f}" for k, v in sorted(
                families.items(), key=lambda kv: -kv[1])[:5])
            median = statistics.median(step_ms)
            idle = 1 - busy / median
            peak = torch.cuda.max_memory_allocated() / 2**30
            rows_b = int(batch["label"].shape[1])
            single = SINGLE_STEP_MS.get((bench, model_type))
            phase = {"vggsound": 7, "cremad": 14}.get(bench, "17b")
            beside = ("the single-seed step not measured in this run"
                      if single is None else
                      f"the single-seed step {single:.3f} ms (phase {phase} "
                      f"of this run), {seeds} of them {seeds * single:.3f} ms")
            log(f"[multiseed] 21c {card}: {bench} {model_type}, S = {seeds} "
                f"at batch {rows_b}: train step median {median:.3f} ms over "
                f"{SWEEP_TIMED} ({min(step_ms):.3f}-{max(step_ms):.3f}), "
                f"{median / seeds:.3f} ms a seed; {beside}; one profiled step "
                f"{wall:.3f} ms, device busy {busy:.3f} ms (kernels summed "
                f"{summed:.3f} ms: {top}), idle share "
                f"{idle:.3f} of the median step; peak memory {peak:.2f} GiB; "
                f"run of {seen['train']} train and {seen['eval']} eval "
                f"steps {run_s:.1f} s; launches {launches}; test_avg_acc "
                f"{summary['test_epoch/test_avg_acc']:.4f} ± "
                f"{summary['test_epoch/test_avg_acc_std']:.4f}")
            log(f"[multiseed] 21c {bench} {model_type} seeds.csv: "
                f"{' | '.join(rows[:2] + rows[-2:])}")
            del train, state, batch, seen
            torch.cuda.empty_cache()
    return total, pool_shapes


# phase 22 writes its runs here, and removes them after
SWITCH_DIR = WORK_DIR / "switches"
# 22a: (stem_space_to_depth, remat) of the fixture's runs from one state,
# the first case again last as the witness of the run-to-run gap
REMAT_CASES = ((False, None), (False, "convs"), (False, "none"),
               (True, None), (False, None))
REMAT_STEPS, REMAT_HELD = 4, 3  # one warm-up and three timed; held after 3
# the bf16 fixture at full width, a remat run against the no-remat run
# from the same state: the losses (relative) and the running buffers (of
# each tensor's largest entry) within REMAT_WITNESS times the gap of the
# no-remat run against itself (cuDNN may pick weight-gradient algorithms
# that add in another order from run to run), or REMAT_FLOOR where that
# gap is smaller: recompute runs the same ops on the same inputs
REMAT_WITNESS, REMAT_FLOOR = 4.0, 1e-5
# the conv outputs the "convs" policy saves a step: each tower's 8 blocks
# save conv1 and conv2, and its 3 projecting blocks the projection
REMAT_SAVED = 2 * (2 * 8 + 3)
# 22b: torchvision resnet50's geometry with every BN the BN-sums one: the
# stem's, 3 in each of 16 blocks, and the 4 projections
BOTTLENECK_BATCH, BOTTLENECK_CLASSES, BOTTLENECK_STEPS = 32, 101, 4
BOTTLENECK_BNS = 1 + 3 * 16 + 4
# 22c: the served program against the eval step on the same batch, bf16:
# both run the same ops, so the stacked logits and the log-probabilities
# agree to within a bf16 rounding of the logits' scale
SERVE_TOL = 2.0 ** -6
SERVE_TIMED = 3
PREPROCESS_CLIPS = 6


def _restore(state, snapshot):
    model, optimizer, ema = snapshot
    state.model.load_state_dict(model)
    state.optimizer.load_state_dict(optimizer)
    state.ema = ema.clone()
    state.step = 0
    return state


def _gap(run, base):
    """(largest relative loss gap, largest running-buffer gap in units of
    each tensor's largest entry) of two 22a runs."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                   base["losses"]))
    buffers = max(_scaled_err(run["buffers"][k], v)
                  for k, v in base["buffers"].items())
    return loss, buffers


@contextlib.contextmanager
def _saved_ops(ops):
    """While open, the "convs" policy's MUST_SAVE answers in a forward are
    appended to ``ops`` (the op's name)."""
    from torch.utils.checkpoint import CheckpointPolicy

    from multimodal_clinical_tpu_torch.models import resnet

    policy = resnet._save_conv_outputs

    def recording(ctx, op, *args, **kwargs):
        choice = policy(ctx, op, *args, **kwargs)
        if choice == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            ops.append(str(op))
        return choice

    resnet._save_conv_outputs = recording
    try:
        yield ops
    finally:
        resnet._save_conv_outputs = policy


def _remat_fixture(device, card: str):
    """22a at full width: the fixture (batch 224, 309 classes, bf16, the
    stored-index pool) under each of REMAT_CASES from one state; returns
    the launches summed over the remat runs and the pool shapes held."""
    import copy

    from multimodal_clinical_tpu_torch.benchmarks.vggsound_fixture import (
        build_vggsound_bench,
    )

    t = time.perf_counter()
    train_step, state, batch, _ = build_vggsound_bench(
        BATCH, CLASSES, pool_kernel="pallas", device=device)
    towers = (state.model.x1_model, state.model.x2_model)
    snapshot = ({k: v.clone() for k, v in state.model.state_dict().items()},
                copy.deepcopy(state.optimizer.state_dict()), state.ema.clone())
    log(f"[switches] 22a fixture built in {time.perf_counter() - t:.1f} s")
    runs, total, saved = [], collections.Counter(), []
    with _recording_calls() as calls:
        launchers = _all_launchers()
        for s2d, remat in REMAT_CASES:
            state = _restore(state, snapshot)
            for enc in towers:
                enc.conv1.space_to_depth, enc.remat = s2d, remat
            for fn in launchers.values():
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats()
            losses, step_ms, ops = [], [], []
            with _saved_ops(ops):
                for i in range(REMAT_STEPS):
                    tic = time.perf_counter()
                    state, metrics = train_step(state, batch)
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - tic) * 1e3)
                    losses.append(float(metrics["train_loss"]))
                    if i + 1 == REMAT_HELD:
                        buffers = {k: v.float().clone() for k, v in
                                   state.model.state_dict().items()
                                   if "running" in k}
            launches = {n: fn.launches for n, fn in launchers.items()}
            wall, busy = _profiled_step(train_step, state, batch)
            want = {"log_spectrogram": REMAT_STEPS,
                    "maxpool_fwd": 2 * REMAT_STEPS,
                    "maxpool_bwd": 2 * REMAT_STEPS}
            if launches != {n: want.get(n, 0) for n in launches}:
                raise AssertionError(f"22a s2d={s2d} remat={remat!r}: "
                                     f"launches {launches}, want {want}")
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"22a non-finite losses {losses}")
            if len(ops) != (REMAT_SAVED * REMAT_STEPS if remat == "convs"
                            else 0) or set(ops) - {"aten.convolution.default"}:
                raise AssertionError(f"22a remat={remat!r}: the policy "
                                     f"saved {collections.Counter(ops)}")
            if remat:
                total.update(launches)
            run = dict(s2d=s2d, remat=remat, losses=losses[:REMAT_HELD],
                       buffers=buffers,
                       ms=statistics.median(step_ms[1:]),
                       peak=torch.cuda.max_memory_allocated() / 2**30)
            runs.append(run)
            log(f"[switches] 22a {card}: stem_space_to_depth={s2d} "
                f"remat={remat!r}: train step median {run['ms']:.2f} ms over "
                f"{REMAT_STEPS - 1} ({', '.join(f'{m:.2f}' for m in step_ms)}"
                f" with the warm-up), peak memory {run['peak']:.2f} GiB; one "
                f"profiled step {wall:.2f} ms, device busy {busy:.2f} ms, "
                f"idle share {1 - busy / run['ms']:.3f} of the median step; "
                f"losses {losses}, launches {launches}"
                + (f", the policy saved {collections.Counter(ops)}"
                   if ops else ""))
        for enc in towers:
            enc.conv1.space_to_depth, enc.remat = False, None
    del train_step, state, batch, snapshot
    torch.cuda.empty_cache()
    base, witness = runs[0], _gap(runs[-1], runs[0])
    for run in runs[1:-1]:
        gap = _gap(run, base)
        if run["remat"] is not None:
            limits = [max(REMAT_WITNESS * w, REMAT_FLOOR) for w in witness]
            if not all(g <= lim for g, lim in zip(gap, limits)):
                raise AssertionError(
                    f"22a remat={run['remat']!r}: losses and buffers "
                    f"{gap} from the no-remat run's, past {limits}")
        log(f"[switches] 22a stem_space_to_depth={run['s2d']} remat="
            f"{run['remat']!r} against the plain run after {REMAT_HELD} "
            f"steps: losses within {gap[0]:.3e} relative, running buffers "
            f"within {gap[1]:.3e} of each tensor's largest entry (the plain "
            f"run against itself: {witness[0]:.3e}, {witness[1]:.3e}); "
            f"step {run['ms'] - base['ms']:+.2f} ms, peak "
            f"{run['peak'] - base['peak']:+.2f} GiB")
    shapes = _check_path_pools(calls, "22a")
    return total, shapes


def _switches_card_against_cpu(device):
    """22a's narrow checks, fp32 and TF32 off: the narrow fixture under
    each remat (the second with the space-to-depth stem) on the card
    against the CPU; the narrow switched encoder under "convs".  Returns
    the card's launches on the encoder path."""
    cpu = torch.device("cpu")
    with _torch_set(False, False, 2):
        for knobs in (dict(remat="none"),
                      dict(remat="convs", stem_space_to_depth=True)):
            _compare_fp32_steps(
                _narrow_step(device, torch.float32, pool_kernel="pallas",
                             **knobs),
                _narrow_step(cpu, torch.float32, pool_kernel="pallas",
                             **knobs), f"22a {knobs}")
        card = _narrow_encoder(device, remat="convs")
        # the 20 BNs forward, the 19 inside blocks again in the recompute
        _compare_narrow_encoders(
            card, _narrow_encoder(cpu, remat="convs"),
            {"bn_sums": 20 + 19, "bn_bwd_sums": 20, "maxpool_fwd": 1,
             "maxpool_bwd": 1}, ", remat='convs'")
    return card["launches"]


def _bottleneck_bn_fused(device, card: str):
    """22b: the resnet50 Bottleneck tower with ``bn_fused=True`` and a
    101-way head, trained with SGD at batch 32 of 224 x 224 in bf16;
    then both BN-sums kernels against their plain versions at every shape
    the steps gave them.  Returns the steps' launches."""
    from multimodal_clinical_tpu_torch.models.common import (
        TorchDense, global_avg_pool, init_weights,
    )
    from multimodal_clinical_tpu_torch.models.resnet import (
        BottleneckResNetEncoder,
    )

    enc = BottleneckResNetEncoder(3, (3, 4, 6, 3), dtype=torch.bfloat16,
                                  bn_fused=True)
    head = TorchDense(enc.out_features, BOTTLENECK_CLASSES, torch.bfloat16)
    net = torch.nn.ModuleList([enc, head])
    init_weights(net, torch.Generator().manual_seed(0))
    net.to(device, memory_format=torch.channels_last)
    opt = torch.optim.SGD(net.parameters(), lr=0.01, momentum=0.9)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(BOTTLENECK_BATCH, 224, 224, 3))
                         .astype(np.float32)).to(device, torch.bfloat16)
    label = torch.from_numpy(rng.integers(0, BOTTLENECK_CLASSES,
                                          BOTTLENECK_BATCH)).to(device)
    torch.cuda.reset_peak_memory_stats()

    def train_step(state, batch):
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(head(global_avg_pool(enc(x))).float(), label)
        loss.backward()
        opt.step()
        return state, loss.detach()

    step_ms, losses = [], []
    with _recording_calls() as calls:
        launchers = _all_launchers()
        for fn in launchers.values():
            fn.launches = 0
        for _ in range(BOTTLENECK_STEPS):
            tic = time.perf_counter()
            _, loss = train_step(None, None)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - tic) * 1e3)
            losses.append(float(loss))
        launches = {n: fn.launches for n, fn in launchers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    wall, busy = _profiled_step(train_step, None, None)
    median = statistics.median(step_ms[1:])
    want = {"bn_sums": BOTTLENECK_BNS * BOTTLENECK_STEPS,
            "bn_bwd_sums": BOTTLENECK_BNS * BOTTLENECK_STEPS}
    if launches != {n: want.get(n, 0) for n in launches} or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"22b launches {launches}, want {want}; "
                             f"losses {losses}")
    if any(float(m.running_mean.abs().sum()) == 0 for m in enc.modules()
           if hasattr(m, "running_mean")):
        raise AssertionError("22b: a BN's running mean did not move")
    log(f"[switches] 22b {card}: resnet50 bn_fused, batch "
        f"{BOTTLENECK_BATCH} of 224 x 224, bf16: train step median "
        f"{median:.2f} ms over {BOTTLENECK_STEPS - 1} "
        f"({', '.join(f'{m:.2f}' for m in step_ms)} with the warm-up), peak "
        f"memory {peak:.2f} GiB; one profiled step {wall:.2f} ms, device "
        f"busy {busy:.2f} ms, idle share {1 - busy / median:.3f} of the "
        f"median step; losses {losses}, "
        f"{launches['bn_sums'] // BOTTLENECK_STEPS} BN-sums launches a "
        f"step each way")
    del enc, head, net, opt, x
    torch.cuda.empty_cache()
    shapes = collections.Counter(calls["bn_sums"])
    if shapes != collections.Counter(calls["bn_bwd_sums"]) or not any(
            c == 2048 for _, c in shapes):
        raise AssertionError(f"22b BN-sums shapes {dict(shapes)}")
    worst = [0.0, 0.0]
    for i, (m, c) in enumerate(sorted(shapes)):
        fwd, bwd = _check_bn(*_bn_case(m, c, torch.bfloat16, 100 + i),
                             f"22b ({m}, {c})")
        worst = [max(worst[0], fwd[1]), max(worst[1], bwd[1])]
    torch.cuda.empty_cache()
    log(f"[kernels] BN sums at the {len(shapes)} shapes of 22b "
        f"({', '.join(f'{s} x{n}' for s, n in sorted(shapes.items()))}): "
        f"forward within {worst[0]:.2e}, backward within {worst[1]:.2e} of "
        f"the terms' magnitude, two launches bit-equal")
    return launches


def _serve(device, card: str):
    """22c: the VGGSound jprobas CLI's run (its ``run_benchmark``) at full
    width for one epoch on waveform rows, ``predict`` on its best
    checkpoint, ``export --batch sym`` and the served program on one test
    batch, beside the eval step on it.  Returns the log-STFT's launches
    from ``predict`` on (one an eval or served batch)."""
    from multimodal_clinical_tpu_torch.benchmarks import vggsound
    from multimodal_clinical_tpu_torch.config import load_config
    from multimodal_clinical_tpu_torch.engine import run
    from multimodal_clinical_tpu_torch.engine.steps import make_eval_step
    from multimodal_clinical_tpu_torch.ops import cuda_spectrogram as cs
    from multimodal_clinical_tpu_torch.tools import export, predict

    work = SWITCH_DIR / "serve"
    bundle = _waveform_bundle(BATCH, BATCH)
    args = load_config("vggsound", overrides=dict(
        num_epochs=1, batch_size=BATCH, loader_workers=4,
        ckpt_dir=str(work), data_path=str(work / "none")))
    module = SimpleNamespace(get_data=lambda _: bundle,
                             get_model_spec=vggsound.get_model_spec)
    t = time.perf_counter()
    summary = run.run_benchmark(args, module, device=device)
    ckpt = str(work / args.group_name / "ckpt")
    log(f"[serve] one epoch through run_benchmark: "
        f"{time.perf_counter() - t:.1f} s, test_avg_acc "
        f"{summary['test_epoch/test_avg_acc']:.6f}")
    cs.launch_log_spectrogram.launches = 0
    t = time.perf_counter()
    rows, got = predict.predict(args, module, "test", ckpt, "best",
                                device=device)
    launches = cs.launch_log_spectrogram.launches
    # one epoch: the best checkpoint holds the weights the trainer tested
    if (got["n"] != len(bundle.test) or launches != 1
            or abs(got["acc"] - summary["test_epoch/test_avg_acc"]) > 1e-6):
        raise AssertionError(f"22c predict: {got}, {launches} log-STFT "
                             f"launches, trainer {summary}")
    log(f"[serve] predict: {got['n']} rows, acc {got['acc']:.6f} (the "
        f"trainer's {summary['test_epoch/test_avg_acc']:.6f}), {launches} "
        f"log-STFT launch, {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    out_dir = export.export_benchmark(args, module, ckpt, "best", "sym",
                                      str(work / "artifact"), device=device)
    export_s = time.perf_counter() - t
    serve = export.load_artifact(out_dir)
    sample = bundle.test.gather(np.arange(BATCH))
    inputs = [torch.from_numpy(sample[k]).to(device)
              for k in ("x1_waveform", "x2")]
    before = cs.launch_log_spectrogram.launches
    served = serve(*inputs)
    torch.cuda.synchronize()
    served_launches = cs.launch_log_spectrogram.launches - before
    _, spec, state = predict.restore_state(args, module, ckpt, "best", device)
    batch = dict(zip(("x1_waveform", "x2"), inputs))
    batch.update(label=torch.from_numpy(sample["label"]).to(device),
                 valid=torch.ones(BATCH, device=device),
                 idx=torch.arange(BATCH, device=device))
    evaluated = make_eval_step(spec)(state, batch)
    stack = evaluated["logits_stack"]
    want_logp = torch.log_softmax(torch.log(
        stack.exp().mean(dim=1) + 1e-7), dim=-1)
    scale = max(1.0, float(stack.abs().max()))
    err = max(float((served["logits_stack"] - stack).abs().max()),
              float((served["logprobs"] - want_logp).abs().max())) / scale
    top2 = want_logp.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * err * scale
    agree = served["pred"].long() == want_logp.argmax(-1)
    if served_launches != 1 or not err <= SERVE_TOL or not bool(
            agree[clear].all()):
        raise AssertionError(f"22c served: {served_launches} log-STFT "
                             f"launches, error {err:.3e}, predictions "
                             f"{int(agree.sum())}/{BATCH} as the eval's")
    ms = []
    for _ in range(SERVE_TIMED):
        tic = time.perf_counter()
        serve(*inputs)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - tic) * 1e3)
    log(f"[serve] {card}: export --batch sym --device cuda {export_s:.1f} s "
        f"({os.path.getsize(os.path.join(out_dir, 'serving.pt2')) / 1e6:.1f}"
        f" MB); served batch of {BATCH} ms {', '.join(f'{m:.2f}' for m in ms)}"
        f" (median {statistics.median(ms):.2f}); {served_launches} log-STFT "
        f"launch inside the served program; against the eval step within "
        f"{err:.3e} of the logits' scale, predictions "
        f"{int(agree.sum())}/{BATCH} equal ({int(clear.sum())} clear of a "
        f"tie)")
    del state, served, evaluated, serve
    torch.cuda.empty_cache()
    return cs.launch_log_spectrogram.launches


def _preprocess_cremad_audio(device):
    """22d: ``tools/preprocess.py cremad-audio`` on fabricated wavs on the
    card against the CPU, each pickle within DISK_SPEC_TOL of its largest
    entry."""
    import pickle

    from multimodal_clinical_tpu_torch.benchmarks.disk_fixture import (
        wav_bytes, wave_pool,
    )
    from multimodal_clinical_tpu_torch.tools import preprocess

    work = SWITCH_DIR / "preprocess"
    (work / "wav").mkdir(parents=True)
    for i, pcm in enumerate(wave_pool(7, PREPROCESS_CLIPS, 2.5)):
        (work / "wav" / f"clip{i}.wav").write_bytes(wav_bytes(pcm))
    for side, dev in (("card", str(device)), ("cpu", "cpu")):
        preprocess.main(["cremad-audio", "--wav-dir", str(work / "wav"),
                         "--out", str(work / side), "--batch-size", "4",
                         "--device", dev])
    worst = 0.0
    for i in range(PREPROCESS_CLIPS):
        got, want = (pickle.loads((work / side / f"clip{i}.pkl").read_bytes())
                     for side in ("card", "cpu"))
        err = float(np.abs(got - want).max() / np.abs(want).max())
        if got.shape != want.shape or not err <= DISK_SPEC_TOL:
            raise AssertionError(f"22d clip{i}: {got.shape} {want.shape}, "
                                 f"{err:.3e}")
        worst = max(worst, err)
    log(f"[preprocess] cremad-audio, {PREPROCESS_CLIPS} wavs in batches of "
        f"4: the card's pickles against the CPU's within {worst:.2e} of "
        f"each one's largest entry")


def phase_switches(device, card: str, kernels):
    """Phase 22: the tower switches and the tools.  (a) the fixture under
    remat and the space-to-depth stem, narrow card-against-CPU runs and
    the narrow switched encoder under "convs"; (b) the resnet50 Bottleneck
    tower with bn_fused; (c) predict, export and the served program; (d)
    preprocess cremad-audio.  Each path's launch counts are set to 0 just
    before it runs and read just after."""
    t0 = time.perf_counter()
    shutil.rmtree(SWITCH_DIR, ignore_errors=True)
    try:
        narrow = _switches_card_against_cpu(device)
        with _torch_set(*TORCH_DEFAULTS):
            remat, pool_shapes = _remat_fixture(device, card)
            remat.update(narrow)
            bottleneck = _bottleneck_bn_fused(device, card)
            serve = {"log_spectrogram": _serve(device, card)}
            _preprocess_cremad_audio(device)
    finally:
        shutil.rmtree(SWITCH_DIR, ignore_errors=True)
    for entry in kernels:
        paths = entry.setdefault("launches_by_path", {})
        name = entry["name"]
        paths["remat"] = remat.get(name, 0)
        paths["bottleneck_bn_fused"] = bottleneck.get(name, 0)
        paths["serve"] = serve.get(name, 0)
        if name in ("maxpool_fwd", "maxpool_bwd"):
            entry.setdefault("checked_shapes_by_path", {})[
                "remat"] = pool_shapes
    log(f"[switches] launches of every TPU kernel: remat {dict(remat)}; "
        f"bottleneck_bn_fused {bottleneck}; serve {serve}; phase 22 took "
        f"{time.perf_counter() - t0:.1f} s")


@contextlib.contextmanager
def _phase_time(name: str, seconds: dict):
    """Adds the block's wall seconds to ``seconds[name]`` and logs them."""
    t = time.perf_counter()
    try:
        yield
    finally:
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
        log(f"[time] phase {name}: {seconds[name]:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"[device] {card}; {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    seconds = {}
    with _phase_time("2", seconds):
        phase_build()
    with _phase_time("3", seconds):
        kernels = phase_kernels(device)
    with _phase_time("4-5", seconds):
        kernels += phase_switched_kernels(
            device, *phase_switched_towers(device, card))
    with _phase_time("6", seconds):
        phase_card_against_cpu(device)
    with _phase_time("7-8", seconds):
        fixture_ms = phase_main_path(device, card, kernels)
    with _phase_time("11", seconds):
        phase_cli(device)
    with _phase_time("12", seconds):
        phase_loop(device, card, fixture_ms, kernels)
    with _phase_time("9-10", seconds):
        kernels += phase_probe_kernels(phase_probes(card))
    with _phase_time("13", seconds):
        phase_contracts_card_against_cpu(device)
    with _phase_time("14", seconds):
        phase_full_width(device, card, kernels)
    with _phase_time("15", seconds):
        phase_contracts_cli(device)
    with _phase_time("16", seconds):
        try:
            trees = phase_disk_build()
            phase_disk_vggsound(device, card, trees, kernels)
            phase_disk_contracts(device, card, trees, kernels)
        finally:
            shutil.rmtree(DISK_DIR, ignore_errors=True)
    with _phase_time("17", seconds):
        phase_small_benchmarks(device, card, kernels)
    with _phase_time("18", seconds):
        phase_wide_benchmarks(device, card, kernels)
    with _phase_time("19", seconds):
        phase_food101(device, card, kernels)
    with _phase_time("20", seconds):
        phase_food101_legacy(device, card, kernels)
    with _phase_time("21", seconds):
        phase_multiseed(device, card, kernels)
    with _phase_time("22", seconds):
        phase_switches(device, card, kernels)
    log(f"[time] every phase, wall s: {json.dumps({k: round(v, 1) for k, v in seconds.items()})}; "
        f"the script so far {time.perf_counter() - t0:.1f} s")
    missing = [e["name"] for e in kernels if not e["launches"]]
    for path in ("food101", "food101_legacy"):
        if any(e.get("launches_by_path", {}).get(path) != 0
               for e in kernels):
            raise AssertionError(f"a kernel lacks its {path}: 0 launches")
    if missing:
        raise AssertionError(f"kernels not launched on their path: {missing}")
    sweep = {e["name"]: e["launches_by_path"] for e in kernels}
    if not all(sweep[n]["multiseed"] for n in (
            "log_spectrogram", "maxpool_fwd", "maxpool_bwd")) or not all(
            sweep[n].get("multiseed_narrow") for n in (
                "bn_sums", "bn_bwd_sums", "maxpool_fwd", "maxpool_bwd")):
        raise AssertionError("a kernel of the sweep did not launch there")
    # rows 1-5 on phase 22's paths
    if not all(sweep[n]["remat"] for n in (
            "log_spectrogram", "bn_sums", "bn_bwd_sums", "maxpool_fwd",
            "maxpool_bwd")) or not all(
            sweep[n]["bottleneck_bn_fused"]
            for n in ("bn_sums", "bn_bwd_sums")) or not sweep[
                "log_spectrogram"]["serve"]:
        raise AssertionError("a kernel of phase 22 did not launch there")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
