"""The port's multi-seed sweep step against its single-seed step, on the
CPU, in fp32: seed s of ``engine/multiseed.py``'s sweep must compute
what ``engine/steps.py``'s train and eval steps compute for seed s.

Each case trains S = 3 seeds for two steps (a full batch, then one with
a padded tail) on per-seed data through
``torch_port_multiseed_harness.run_both`` and holds them with its
``check_seeds`` (its docstring gives the tolerances).  The data seeds
here cross no ReLU or max-pool threshold within fp32 rounding in these
two steps.

Crema-D's narrow net (width 8, one block a stage, 257 x 40 spectrograms
from waveforms, one 32 x 32 frame) runs every contract, with the default
BN and pool and with ``bn_fused=True, pool_kernel="pallas"`` (the plain
versions of the BN-sums and max-pool kernels under their ``vmap``
rules); AVE's net on two frames; VGGSound's preprocess with
SpecAugment; MIMIC's nets under SGD and Adam; dropout heads (the
reference's ``HeadMLP``) on MIMIC's inputs.  Each ``vmap`` rule is also
held against a loop over the seed axis, forward and backward. vmap's
per-sample fallback warning is an error in this file.
"""

from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch import nn
from torch.func import vmap

from multimodal_clinical_tpu_torch.benchmarks import (
    ave, cremad, mimic, vggsound,
)
from multimodal_clinical_tpu_torch.engine.multiseed import (
    _fold, _unfold, create_multiseed_state, make_multiseed_steps,
)
from multimodal_clinical_tpu_torch.engine.state import step_generator
from multimodal_clinical_tpu_torch.models import zoo
from multimodal_clinical_tpu_torch.models.mlp import HeadMLP
from multimodal_clinical_tpu_torch.models.resnet import ResNetEncoder
from multimodal_clinical_tpu_torch.ops import cuda_fused_bn
from multimodal_clinical_tpu_torch.ops.fused_bn import batch_norm_train_stats
from multimodal_clinical_tpu_torch.ops.maxpool import (
    max_pool_3x3_s2_stored_index,
)
from multimodal_clinical_tpu_torch.ops.seed_fold import batch_norm
import torch_port_multiseed_harness as H
from torch_port_multiseed_harness import (  # noqa: F401 (autouse)
    SEEDS, vmap_fallback_is_an_error,
)



torch.set_num_threads(2)

B, VALID_TAIL, N_TRAIN = 6, 4, 18
WIDTH, STAGES, FRAME = 8, (1, 1, 1, 1), 32

# (module, classes, rows of each input as a function of the numpy rng)
BENCHES = {
    "cremad": (cremad, 6, lambda rng, n: {
        "x1_waveform": rng.normal(scale=0.1, size=(n, 512 + 159 * 39)),
        "x2": rng.integers(0, 256, size=(n, 1, FRAME, FRAME, 3),
                           dtype=np.uint8)}),
    "vggsound": (vggsound, 9, lambda rng, n: {
        "x1_waveform": rng.normal(scale=0.1, size=(n, 16000)),
        "x2": rng.integers(0, 256, size=(n, 2, FRAME, FRAME, 3),
                           dtype=np.uint8)}),
    "ave": (ave, 28, lambda rng, n: {
        "x1_waveform": rng.normal(scale=0.1, size=(n, 512 + 159 * 39)),
        "x2": rng.integers(0, 256, size=(n, 2, FRAME, FRAME, 3),
                           dtype=np.uint8)}),
    "mimic": (mimic, 6, lambda rng, n: {
        "x1": rng.normal(size=(n, 5)), "x2": rng.normal(size=(n, 24, 12))}),
}
BENCHES["heads"] = BENCHES["mimic"]


class HeadsNet(nn.Module):
    """The reference's dropout head (``HeadMLP``: Linear, ReLU,
    Dropout(0.2), Linear, ReLU, Dropout(0.2), Linear) on each of MIMIC's
    two inputs: MIMIC's own nets have no dropout."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.x1_model = HeadMLP(num_classes, 5, hidden_dim=16)
        self.x2_model = HeadMLP(num_classes, 24 * 12, hidden_dim=16)

    def forward(self, x1, x2):
        return {"logits": [self.x1_model(x1), self.x2_model(x2.flatten(1))]}


def _batches(bench: str, data_seed: int, steps: int = 2):
    """Per step a dict of numpy rows; the second step has a padded tail
    (the loader repeats the last real row, ``idx`` included)."""
    _, classes, inputs = BENCHES[bench]
    rng = np.random.default_rng(data_seed)
    ids = rng.permutation(N_TRAIN)
    out = []
    for step, real in enumerate((B, VALID_TAIL)[:steps]):
        rows = np.arange(B).clip(max=real - 1)
        batch = {k: v.astype(np.float32) if v.dtype == np.float64 else v
                 for k, v in inputs(rng, B).items()}
        batch.update(label=rng.integers(0, classes, size=B),
                     idx=ids[step * B:(step + 1) * B])
        batch = {k: v[rows] for k, v in batch.items()}
        batch["valid"] = (np.arange(B) < real).astype(np.float32)
        out.append(batch)
    return out


def _spec(bench: str, model_type: str, switched: bool = False):
    module, classes, _ = BENCHES[bench]
    args = SimpleNamespace(num_classes=classes, batch_size=B,
                           learning_rate=1e-2, num_epochs=60,
                           use_scheduler=False, seed=0,
                           model_type=model_type)
    with pytest.MonkeyPatch.context() as mp:
        if bench in ("cremad", "ave", "vggsound"):
            mp.setattr(zoo, "ResNetEncoder", functools.partial(
                ResNetEncoder, stage_sizes=STAGES, bn_fused=switched))
        spec, opt_kwargs = module.get_model_spec(args, n_train=N_TRAIN)
        if bench == "heads":
            spec = dataclasses.replace(spec, module=HeadsNet(classes))
        elif bench != "mimic":
            spec = dataclasses.replace(spec, module=zoo.CremadFusionNet(
                classes, width=WIDTH,
                pool_kernel="pallas" if switched else "xla"))
    return spec, opt_kwargs, args


def run_both(bench: str, model_type: str, switched: bool = False,
             data_seed: int = 3, steps: int = 2):
    """``torch_port_multiseed_harness.run_both`` on ``bench``'s rows, seed
    s's drawn from ``data_seed + 10 * s``."""
    data = [[H.to_torch(b) for b in _batches(bench, data_seed + 10 * s, steps)]
            for s in range(len(SEEDS))]
    return H.run_both(lambda: _spec(bench, model_type, switched), data)


def check_seeds(singles, swept, spec):
    H.check_seeds(singles, swept, spec, history_rows=B + VALID_TAIL)


@pytest.mark.parametrize("switched", [False, True],
                         ids=["default", "bn_fused+pallas_pool"])
@pytest.mark.parametrize("model_type",
                         ["jlogits", "jprobas", "ensemble", "ogm_ge", "qmf"])
def test_cremad_sweep_equals_single_seed_runs(model_type, switched):
    singles, swept, spec = run_both("cremad", model_type, switched)
    check_seeds(singles, swept, spec)
    if model_type == "ogm_ge":
        assert spec.grad_mod_type == "OGM_GE"


@pytest.mark.parametrize("model_type", ave.MODEL_TYPES)
def test_ave_sweep_equals_single_seed_runs(model_type):
    """AVE's preprocess (two frames a clip, one frequency and one time
    band drawn per seed) and its net, for one step: its time band (up to
    60 of the 40 frames here, and of 160 as well) zeroes whole stem
    windows, and past the first step the runs part as VGGSound's do
    (below); with bands a frame wide they agree to 1e-8 over two."""
    singles, swept, spec = run_both("ave", model_type, steps=1)
    check_seeds(singles, swept, spec)


def test_vggsound_sweep_draws_each_seeds_spec_augment():
    """The device preprocess on the folded (S * B) rows equals each seed's
    own bit for bit: one log-STFT call for the S seeds, SpecAugment's bands
    drawn from each seed's step generator.  The first step's metrics agree
    too.  Past it the runs part: the draws' wide bands zero whole stem
    windows, and which tied tap of the stem max-pool gets the gradient
    turns on the last bit of the convolutions' rounding
    (``test_torch_port_step.py``), grouped or not."""
    spec, _, _ = _spec("vggsound", "jprobas")
    data = [H.to_torch(_batches("vggsound", 3 + 10 * s, 1)[0])
            for s in range(len(SEEDS))]
    folded, seeds = _fold(H.stacked(data))
    swept = _unfold(spec.device_preprocess(
        folded, [step_generator(seed, 5) for seed in SEEDS], True), seeds)
    for s, seed in enumerate(SEEDS):
        own = spec.device_preprocess(dict(data[s]), step_generator(seed, 5),
                                     True)
        assert set(own) == set(swept)
        for k, v in own.items():
            torch.testing.assert_close(swept[k][s], v, rtol=0, atol=0)
    # the bands differ from seed to seed
    assert not torch.equal(swept["x1"][0] == 0, swept["x1"][1] == 0)
    singles, swept_run, _ = run_both("vggsound", "jprobas", steps=1)
    for s, single in enumerate(singles):
        H.check_values({k: v[s] for k, v in swept_run["metrics"][0].items()},
                       single["metrics"][0], f"seed {s} step 0")


@pytest.mark.parametrize("model_type", ["jlogits", "jprobas", "ensemble",
                                        "qmf"])
def test_mimic_sweep_equals_single_seed_runs(model_type):
    """SGD (jlogits, ensemble, qmf) and Adam (jprobas)."""
    singles, swept, spec = run_both("mimic", model_type)
    check_seeds(singles, swept, spec)


@pytest.mark.parametrize("model_type", ["jlogits", "qmf"])
def test_dropout_masks_are_each_seeds_own(model_type):
    """Every dropout of seed s draws the mask that seed s's run draws
    (``device_dropout(seed, step)``): the losses, updates and eval agree."""
    singles, swept, spec = run_both("heads", model_type)
    assert sum(type(m).__name__ == "Dropout"
               for m in spec.module.modules()) == 4
    check_seeds(singles, swept, spec)


def test_one_vmap_one_backward_one_optimizer_step(monkeypatch):
    """The sweep runs the forward once per step for all seeds: the model's
    forward is entered once, on per-seed shapes, inside one vmap."""
    spec, opt_kwargs, args = _spec("cremad", "jlogits")
    sweep = create_multiseed_state(spec, args, SEEDS, steps_per_epoch=100,
                                   device="cpu", opt_kwargs=opt_kwargs)
    calls, steps = [], []
    forward = type(sweep.model).forward

    def counted(self, x1, x2):
        calls.append((tuple(x1.shape), torch._C._functorch.is_batchedtensor(
            x1)))
        return forward(self, x1, x2)

    monkeypatch.setattr(type(sweep.model), "forward", counted)
    step_fn = sweep.optimizer.step
    monkeypatch.setattr(sweep.optimizer, "step",
                        lambda: (steps.append(1), step_fn())[1])
    train, _ = make_multiseed_steps(spec)
    batch = H.stacked([H.to_torch(_batches("cremad", 3 + s, 1)[0])
                      for s in range(len(SEEDS))])
    train(sweep, batch)
    assert calls == [((B, 257, 40, 1), True)]
    assert steps == [1]
    # one leaf a parameter name, stacked on the seed axis
    assert all(p.shape[0] == len(SEEDS) and p.is_leaf
               for p in sweep.params.values())


# -- the vmap rules against a loop over the seed axis ----------------------

def _layouts(seeds, b, h, w, c, seed=0):
    """The same (S, B, H, W, C) values in two memory layouts: seed axis
    next to the channels (as the seed-grouped convolutions leave it: the
    fold is a view) and seed axis leading (the fold copies)."""
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(seeds, b, h, w, c)).astype(np.float32))
    near = x.permute(1, 2, 3, 0, 4).contiguous().permute(3, 0, 1, 2, 4)
    return {"seed_next_to_channels": near, "seed_leading": x.contiguous()}


def _rule_against_loop(fn, x, *per_seed):
    """vmap(fn) and the loop over seeds: outputs and the gradients of a
    fixed weighted sum of them with respect to every input."""
    def run(batched):
        leaves = [t.detach().clone().requires_grad_() for t in (x, *per_seed)]
        if batched:
            out = vmap(fn)(*leaves)
        else:
            out = torch.stack([fn(*(t[s] for t in leaves))
                               for s in range(x.shape[0])])
        weight = torch.linspace(-1.0, 2.0, out.numel()).view(out.shape)
        (out * weight).sum().backward()
        return out.detach(), [t.grad for t in leaves]

    (out, grads), (want, want_grads) = run(True), run(False)
    return out, want, grads, want_grads


@pytest.mark.parametrize("layout", ["seed_next_to_channels", "seed_leading"])
def test_pool_rule_equals_a_loop_over_seeds(layout):
    x = _layouts(3, 2, 9, 7, 8)[layout]
    out, want, grads, want_grads = _rule_against_loop(
        max_pool_3x3_s2_stored_index, x)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(grads[0], want_grads[0], rtol=0, atol=0)


@pytest.mark.parametrize("channels", [8, 1024],
                         ids=["within_max_c", "past_max_c"])
@pytest.mark.parametrize("layout", ["seed_next_to_channels", "seed_leading"])
def test_fused_bn_rule_equals_a_loop_over_seeds(layout, channels):
    """The rule folds the seeds into the channels; on the CPU (the plain
    sums) also past the BN-sums kernels' MAX_C (3 * 1024)."""
    assert (3 * channels <= cuda_fused_bn.MAX_C) == (channels == 8)
    x = _layouts(3, 2, 5, 3, channels)[layout]
    rng = np.random.default_rng(1)
    scale = torch.from_numpy(rng.normal(1.0, 0.1, (3, channels))
                             .astype(np.float32))
    bias = torch.from_numpy(rng.normal(0.0, 0.1, (3, channels))
                            .astype(np.float32))

    def fn(x, scale, bias):
        y, mean, var = batch_norm_train_stats(x, scale, bias)
        return y * (1.0 + mean + var)

    out, want, grads, want_grads = _rule_against_loop(fn, x, scale, bias)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    for got, ref in zip(grads, want_grads):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


def test_fused_bn_rule_refuses_past_max_c_off_the_cpu():
    """Off the CPU the folded (S * C) channels go to the kernels, which
    take at most MAX_C: past it the rule raises before any work (meta
    tensors stand in for the card's)."""
    c = cuda_fused_bn.MAX_C // 2 + 1
    x = torch.empty(2, 4, 3, 3, c, device="meta")
    scale = torch.ones(2, c, device="meta")
    with pytest.raises(ValueError, match="past the BN-sums kernels' MAX_C"):
        vmap(lambda x, s: batch_norm_train_stats(x, s, s)[0])(x, scale)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_default_bn_rule_equals_a_loop_over_seeds(training, dtype):
    """``ops/seed_fold.batch_norm`` on (N, C, H, W) maps (the NCHW view of
    the NHWC layouts): the batch statistics it writes, its output and
    gradients; bf16 inputs beside fp32 weights, which vmap's own rule for
    ``F.batch_norm`` refuses."""
    x = _layouts(3, 4, 5, 3, 6)[
        "seed_next_to_channels"].permute(0, 1, 4, 2, 3).to(dtype)
    rng = np.random.default_rng(2)
    weight = torch.from_numpy(rng.normal(1.0, 0.1, (3, 6)).astype(np.float32))
    stats = torch.from_numpy(rng.normal(0.0, 0.1, (3, 6)).astype(np.float32))

    def fn(x, weight, stats):
        mean, var = torch.zeros_like(stats), torch.ones_like(stats)
        if not training:
            mean, var = stats.detach(), stats.detach().abs() + 1.0
        y = batch_norm(x, mean, var, weight, stats, training, 1.0, 1e-5)
        return y.float() * (1.0 + mean[:, None, None] + var[:, None, None])

    out, want, grads, want_grads = _rule_against_loop(fn, x, weight, stats)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    for got, ref in zip(grads, want_grads):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
