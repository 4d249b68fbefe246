"""Shared harness of ``test_torch_port_{contracts,cremad,ave}.py``: one
model type of one benchmark, trained for two steps and evaluated once by
the JAX package and by the port from the same weights and inputs, on the
CPU, in fp32.  Its checks also hold the AV-MNIST, MIMIC and MUsTARD runs
of ``torch_port_benchmark_harness.py`` (``check_state`` under plain SGD
and Adam too).

Each side builds its spec with its own ``get_model_spec`` (the towers
narrowed on both sides: width 8, one block per stage).  The JAX init
draws the weights (compiled once per benchmark), and
``models/jax_weights.py`` carries them into the port.  Each side runs
its benchmark's own ``device_preprocess`` on the batch's waveform and
uint8 frames.  The two frameworks draw different random streams, so the
random parts are injected on both sides:

  * SpecAugment masks: the JAX ``ops/specaugment.py::_axis_mask`` and the
    port's ``spec_augment_masks`` (in the benchmark module's namespace)
    are replaced by functions that return the same narrow numpy masks for
    each step and record the parameters they were asked to draw with,
    which must agree (AVE: one band each of width < 15 and < 60;
    VGGSound: two and three bands, < 30 and < 120).  The JAX step is
    compiled once, so its stand-in picks each step's masks by the key it
    is given: that step's key as the JAX step derives it.  The JAX
    ``spec_augment`` runs unjitted, so that the stand-in is traced anew
    in every run.
  * OGM-GE noise: ``jax.random.normal`` replaced in the JAX OGM module's
    namespace with a fixed draw per 4-D leaf, the port given the same
    arrays by parameter name.  The JAX step is compiled once, so its
    noise is the same in both steps; so is the port's.

The first train batch is full, the second has a padded tail (the loader
repeats the last real row, ``idx`` included), which the QMF scatter must
drop; the eval batch is the second.

Both sides compute the same spectrogram: the JAX front end
(``ops/spectrogram.py``'s ``log_spectrogram`` and ``cremad_spectrogram``)
is replaced by a host callback into the port's (each front end is held
against JAX's in its own test).  Two correct fp32 implementations of these towers part
where a ReLU or max-pool decision sits within rounding of its threshold
(see ``test_torch_port_step.py``), and the two front ends' last-bit
differences alone flipped such decisions in the audio tower of several
model types.  With the shared input, the data of numpy seed
``DATA_SEED`` cross no such threshold in these two steps for any model
type, which the tolerances below (those of ``test_torch_port_step.py``)
would show.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.algos import ogm_ge as jax_ogm
from multimodal_clinical_tpu.benchmarks import ave as jax_ave
from multimodal_clinical_tpu.benchmarks import cremad as jax_cremad
from multimodal_clinical_tpu.benchmarks import vggsound as jax_vggsound
from multimodal_clinical_tpu.engine.state import (
    create_train_state as jax_create_train_state,
)
from multimodal_clinical_tpu.engine.steps import (
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step,
)
from multimodal_clinical_tpu.models import zoo as jax_zoo
from multimodal_clinical_tpu.models.resnet import (
    ResNetEncoder as JaxResNetEncoder,
)
from multimodal_clinical_tpu.ops import spectrogram as jax_spectrogram
from multimodal_clinical_tpu.ops import specaugment as jax_specaugment
from multimodal_clinical_tpu_torch.benchmarks import ave, cremad, vggsound
from multimodal_clinical_tpu_torch.engine.state import create_train_state
from multimodal_clinical_tpu_torch.engine.steps import (
    make_eval_step, make_train_step,
)
from multimodal_clinical_tpu_torch.models import zoo as port_zoo
from multimodal_clinical_tpu_torch.models.jax_weights import (
    get_leaf, jax_key_map, load_jax_variables, to_torch_layout,
)
from multimodal_clinical_tpu_torch.models.resnet import ResNetEncoder
from multimodal_clinical_tpu_torch.ops import cuda_spectrogram, spectrogram
from multimodal_clinical_tpu_torch.ops import specaugment

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

WIDTH, STAGES = 8, (1, 1, 1, 1)
B, VALID_TAIL, N_TRAIN, DATA_SEED = 6, 4, 12, 3
FRAME_SIZE = 32
# per benchmark: (port module, JAX module, classes, frames, waveform
# samples); Crema-D and AVE waveforms give cremad_spectrogram's 257 bins
# and 40 frames, VGGSound's the log-STFT's 129 bins and 126 frames
BENCHMARKS = {
    "cremad": (cremad, jax_cremad, 6, 1, 512 + 159 * 39),
    "ave": (ave, jax_ave, 28, 2, 512 + 159 * 39),
    "vggsound": (vggsound, jax_vggsound, 9, 2, 16000),
}
# fp32 on both sides, summed in another order (test_torch_port_step.py)
LOSS_RTOL = 1e-5
EMA_ATOL = 1e-5
BUFFER_RTOL, BUFFER_ATOL = 1e-4, 1e-5
SCALED_TOL = 3e-4
PARAM_ULPS = 8 * 2.0 ** -23
# the losses among the metrics and eval outputs; the rest (accuracies,
# counts) are equal
CONTINUOUS = ("train_loss", "train_vicreg_loss", "loss", "vicreg_loss")
# QMF History: the batch-mean CE and logsumexp / 10 of fp32 logits,
# written by a scatter: as close as the losses
TABLE_RTOL, TABLE_ATOL = 1e-5, 1e-6


def _narrow_masks(step, f, t):
    """(fmask (B, F), tmask (B, T)): two frequency and two time bands of
    width 1-3 per row (narrow bands: see test_torch_port_step.py)."""
    rng = np.random.default_rng(100 + step)
    masks = []
    for dim in (f, t):
        mask = np.ones((B, dim), np.float32)
        for row in range(B):
            for _ in range(2):
                width = rng.integers(1, 4)
                start = rng.integers(0, dim - width)
                mask[row, start:start + width] = 0.0
        masks.append(mask)
    return masks


def _port_front_end(name, wave, **kwargs):
    """The port's ``name`` front end on a numpy waveform: (B, F, T)."""
    fn = {"log_spectrogram": cuda_spectrogram.log_spectrogram,
          "cremad_spectrogram": spectrogram.cremad_spectrogram}[name]
    return fn(torch.from_numpy(np.array(wave, np.float32)), **kwargs).numpy()


def patch_front_ends(mp):
    """The JAX ``log_spectrogram`` and ``cremad_spectrogram`` replaced by a
    host callback into the port's, with the arguments JAX passes."""
    for name in ("log_spectrogram", "cremad_spectrogram"):
        def callback(wave, _name=name, **kwargs):
            shape = _port_front_end(_name, np.zeros(wave.shape, np.float32),
                                    **kwargs).shape
            return jax.pure_callback(
                lambda w: np.array(_port_front_end(_name, w, **kwargs)),
                jax.ShapeDtypeStruct(shape, jnp.float32), wave)
        mp.setattr(jax_spectrogram, name, callback)


def _key_bits(key):
    if jax.dtypes.issubdtype(key.dtype, jax.dtypes.prng_key):
        return jax.random.key_data(key)
    return key


def patch_mask_draws(mp, port_mod, jstate, masks):
    """Both packages' SpecAugment draws return ``masks[step]`` = (fmask,
    tmask); returns the parameters each was asked to draw with, as
    {"jax": [(dim, mask_param, num_masks), ...], "port": [...]}."""
    drawn = {"jax": [], "port": []}
    f, t = (m.shape[1] for m in masks[0])
    assert f != t  # the stand-in tells the axes apart by their length
    # each train step's (frequency, time) keys: the JAX step's prep key
    # (fold_in(rng, step), third of three), split in two by spec_augment
    keys = []
    for step in range(len(masks)):
        prep = jax.random.split(jax.random.fold_in(jstate.rng, step), 3)[2]
        keys.append([np.asarray(_key_bits(k)) for k in jax.random.split(prep)])

    def axis_mask(rng, batch, dim, mask_param, num_masks):
        drawn["jax"].append((dim, mask_param, num_masks))
        axis = 0 if dim == f else 1
        bits = _key_bits(rng)
        out = jnp.zeros((batch, dim), jnp.float32)  # no step's key: all masked
        for step, pair in enumerate(keys):
            out = jnp.where(jnp.all(bits == pair[axis]),
                            jnp.asarray(masks[step][axis]), out)
        return out

    real = specaugment.spec_augment_masks

    def spec_augment_masks(*args, **kwargs):
        bound = inspect.signature(real).bind(*args, **kwargs)
        bound.apply_defaults()
        a = bound.arguments
        drawn["port"] += [(a["f"], a["freq_mask_param"], a["num_freq_masks"]),
                          (a["t"], a["time_mask_param"], a["num_time_masks"])]
        fmask, tmask = masks[len(drawn["port"]) // 2 - 1]
        return (torch.from_numpy(fmask.copy()).to(a["device"]),
                torch.from_numpy(tmask.copy()).to(a["device"]))

    mp.setattr(jax_specaugment, "spec_augment",
               jax_specaugment.spec_augment.__wrapped__)
    mp.setattr(jax_specaugment, "_axis_mask", axis_mask)
    if hasattr(port_mod, "spec_augment_masks"):
        mp.setattr(port_mod, "spec_augment_masks", spec_augment_masks)
    return drawn


def _batches(bench):
    """Two train batches (the second with a padded tail) as numpy dicts."""
    _, _, classes, frames, samples = BENCHMARKS[bench]
    rng = np.random.default_rng(DATA_SEED)
    ids = rng.permutation(N_TRAIN)
    out = []
    for step, real in enumerate((B, VALID_TAIL)):
        rows = np.arange(B).clip(max=real - 1)  # repeat the last real row
        wave = rng.normal(scale=0.1, size=(B, samples)).astype(np.float32)
        x2 = rng.integers(0, 256, size=(B, frames, FRAME_SIZE, FRAME_SIZE, 3),
                          dtype=np.uint8)
        label = rng.integers(0, classes, size=B)
        idx = ids[step * B:(step + 1) * B]
        valid = (np.arange(B) < real).astype(np.float32)
        out.append({"x1_waveform": wave[rows], "x2": x2[rows],
                    "label": label[rows], "idx": idx[rows], "valid": valid})
    return out


def _to_jax(batch):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in batch.items()}


def _to_port(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _noise(params, rng):
    """One standard-normal draw per 4-D leaf of the JAX walk, in its
    order: [(path, array)]."""
    out = []
    for key in jax_ogm.DEFAULT_ENCODER_KEYS:
        flat, _ = jax.tree_util.tree_flatten_with_path(params[key])
        out += [((key,) + tuple(p.key for p in path),
                 rng.normal(size=leaf.shape).astype(np.float32))
                for path, leaf in flat if leaf.ndim == 4]
    return out


class _Namespace:
    """A module's attributes, some replaced."""

    def __init__(self, module, **replaced):
        self._module, self._replaced = module, replaced

    def __getattr__(self, name):
        if name in self._replaced:
            return self._replaced[name]
        return getattr(self._module, name)


def patch_ogm_normal(mp, normal):
    """``jax.random.normal`` replaced by ``normal`` in the JAX OGM module's
    namespace only (flax's initialisers, which also draw from it, keep
    theirs)."""
    mp.setattr(jax_ogm, "jax", _Namespace(
        jax, random=_Namespace(jax.random, normal=normal)))


_INIT = {}
# XLA's backend optimisations take most of an init's compile, which runs
# once; without them some draws round differently (LeNet's convs' are
# bit-equal, the dense layers' are not).  The narrowed ResNet towers here
# keep the optimised draws, on which their data seed was chosen.
FAST_INIT = {"xla_backend_optimization_level": 0}


def _cached_init(bench, flax_init, compiler_options=None):
    """The flax init of the narrowed towers, compiled once per benchmark
    (its head width is the benchmark's class count; the rest does not
    depend on the inputs' sizes) with ``compiler_options``: it compiles for
    longer than two steps run."""
    def init(module, rngs, *inputs, train=False):
        if bench not in _INIT:
            _INIT[bench] = jax.jit(lambda r, *xs: flax_init(
                module, r, *xs, train=train)).lower(rngs, *inputs).compile(
                    compiler_options)(rngs, *inputs)
        return _INIT[bench]
    return init


def run_pair(bench: str, model_type: str, options=None, nets=None,
             **arg_overrides):
    """Both sides' per-step metrics, eval outputs and final state.

    ``options``: ModelSpec fields set on both specs after
    ``get_model_spec``.  ``nets``: (JAX class, port class) built in place
    of the benchmark's net, each with the parameters of its
    ``CremadFusionNet``.  With ``num_inputs`` 3 the batches carry an
    ``x3`` of shape (B, classes)."""
    port_mod, jax_mod, classes, frames, _ = BENCHMARKS[bench]
    options = dict(options or {})
    args = SimpleNamespace(num_classes=classes, batch_size=B,
                           learning_rate=1e-2, num_epochs=60,
                           use_scheduler=False, seed=0,
                           model_type=model_type, **arg_overrides)
    batches = _batches(bench)
    if options.get("num_inputs") == 3:
        extra = np.random.default_rng(DATA_SEED + 100)
        for batch in batches:
            x3 = extra.normal(size=(B, classes)).astype(np.float32)
            real = int(batch["valid"].sum())
            batch["x3"] = x3[np.arange(B).clip(max=real - 1)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_zoo, "ResNetEncoder",
                   functools.partial(JaxResNetEncoder, width=WIDTH,
                                     stage_sizes=STAGES))
        mp.setattr(port_zoo, "ResNetEncoder",
                   functools.partial(ResNetEncoder, stage_sizes=STAGES))
        mp.setattr(port_mod, "CremadFusionNet",
                   functools.partial(port_zoo.CremadFusionNet, width=WIDTH))
        jspec, _ = jax_mod.get_model_spec(args, n_train=N_TRAIN)
        spec, _ = port_mod.get_model_spec(args, n_train=N_TRAIN)
        if nets is not None:
            options.update(module=nets[0](num_classes=classes))
        jspec = dataclasses.replace(jspec, **options)
        if nets is not None:
            options.update(module=nets[1](classes, width=WIDTH))
        spec = dataclasses.replace(spec, **options)
        mp.setattr(jax_zoo.CremadFusionNet, "init",
                   _cached_init(bench, jax_zoo.CremadFusionNet.init))
        sample = [jnp.zeros((2, 33, 40, 1)),
                  jnp.zeros((2, frames, FRAME_SIZE, FRAME_SIZE, 3))]
        jstate = jax_create_train_state(jspec, args, jax.random.PRNGKey(0),
                                        sample, steps_per_epoch=100)
        params = jax.tree_util.tree_map(np.asarray, jstate.params)
        stats = jax.tree_util.tree_map(np.asarray, jstate.batch_stats)

        state = create_train_state(spec, args, seed=0, steps_per_epoch=100,
                                   device="cpu")
        load_jax_variables(state.model, params, stats)
        init = {k: v.clone() for k, v in state.model.state_dict().items()}

        noise = _noise(params, np.random.default_rng(7))
        calls = []

        def normal(key, shape, dtype=jnp.float32):
            path, arr = noise[len(calls) % len(noise)]
            calls.append(path)
            assert tuple(shape) == arr.shape, path
            return jnp.asarray(arr, dtype)

        patch_ogm_normal(mp, normal)
        patch_front_ends(mp)
        f, t = _port_front_end(
            "log_spectrogram" if bench == "vggsound" else "cremad_spectrogram",
            batches[0]["x1_waveform"]).shape[1:]
        drawn = patch_mask_draws(mp, port_mod, jstate,
                                 [_narrow_masks(step, f, t)
                                  for step in range(len(batches))])
        by_path = {path: name
                   for name, (coll, path, _) in jax_key_map(state.model).items()
                   if coll == "params"}
        port_noise = {by_path[path]: torch.from_numpy(np.ascontiguousarray(
            to_torch_layout("conv", arr))) for path, arr in noise}
        jtrain, jeval = jax_make_train_step(jspec), jax_make_eval_step(jspec)
        train = make_train_step(
            spec, ogm_noise=lambda _: lambda name, g: port_noise[name])
        evaluate = make_eval_step(spec)

        metrics, jmetrics = [], []
        for batch in batches:
            state, m = train(state, _to_port(batch))
            metrics.append({k: float(v) for k, v in m.items()})
            jstate, jm = jtrain(jstate, _to_jax(batch))
            jmetrics.append({k: float(v) for k, v in jm.items()})
        evaluated = {k: v for k, v in batches[-1].items()}
        out = {k: v.numpy() for k, v in evaluate(
            state, _to_port(evaluated)).items()}
        jout = {k: np.asarray(v) for k, v in jeval(
            jstate, _to_jax(evaluated)).items()}
    modulated = bool(jspec.apply_grad_mod and jspec.grad_mod_type
                     and jspec.grad_mod_type != "OGM")
    return dict(spec=spec, jspec=jspec, state=state, jstate=jstate,
                init=init, metrics=metrics, jmetrics=jmetrics, out=out,
                jout=jout, noise_calls=len(calls), modulated=modulated,
                batches=batches, drawn=drawn, masked=bench != "cremad")


# -- the comparisons -------------------------------------------------------

def spec_fields(spec):
    """The fields of a ModelSpec that both packages have."""
    return {f: getattr(spec, f) for f in (
        "contract", "num_modality", "num_inputs", "eval_fusion",
        "fusion_weights", "unimodal_loss_scale", "ensemble_train_mean",
        "test_restore_best", "grad_mod_type", "ogm_alpha", "apply_grad_mod",
        "n_train_samples", "qmf_ablate_train", "qmf_drop_joint",
        "qmf_drop_unimodal", "vicreg_weight", "frozen_prefixes",
        "legacy_metric_aliases", "track_min_loss_counts", "report_logprobs",
        "sched_step_size", "sched_gamma", "use_idx")}



def _scaled_close(got, want, tol, name, atol=0.0):
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max() + atol, (name, err)


def check_train_metrics(run):
    for step, (m, jm) in enumerate(zip(run["metrics"], run["jmetrics"])):
        assert set(m) == set(jm), (step, sorted(m), sorted(jm))
        for k in m:
            if k in CONTINUOUS:
                np.testing.assert_allclose(m[k], jm[k], rtol=LOSS_RTOL,
                                           err_msg=f"step {step} {k}")
            else:
                assert m[k] == jm[k], (step, k, m[k], jm[k])
    # the padded tail counts its real rows only
    assert [m["valid_count"] for m in run["metrics"]] == [B, VALID_TAIL]
    # the JAX walk drew noise for every conv weight once per trace
    assert (run["noise_calls"] > 0) == run["modulated"]
    # SpecAugment: the JAX step traced once, the port drew at both steps,
    # with the same parameters
    drawn = run["drawn"]
    assert bool(drawn["jax"]) == run["masked"]
    assert drawn["port"] == drawn["jax"] * len(run["metrics"])


def _jax_opt_trees(opt_state):
    """The JAX optimizer's per-parameter state by the name torch gives it:
    SGD's momentum trace, Adam's first and second moments, or nothing
    (SGD without momentum)."""
    for s in opt_state:
        if hasattr(s, "trace"):
            return {"momentum_buffer": s.trace}
        if hasattr(s, "mu"):
            return {"exp_avg": s.mu, "exp_avg_sq": s.nu}
    return {}


# Adam moves an entry by lr * m / (sqrt(v) + eps) whatever its
# gradient's size: where a step's gradient entry is within rounding of
# zero (a sum of cancelling terms, rounded in another order on each side)
# the two sides move it by different shares of the learning rate, 5% of
# it measured in fp32 (MUsTARD's fc1 under ensemble, its moments agreeing
# to 4 digits).  So under Adam the updates are held where both sides'
# gradient entries agree to ADAM_GRAD_RTOL at every step (JAX's read back
# from its first moment), at least ADAM_HELD_SHARE of each tensor; the
# moments, which carry the gradients, everywhere.  The float64
# parameter-set test of test_torch_port_small_towers.py holds Adam to
# 1e-6 everywhere.
ADAM_GRAD_RTOL, ADAM_HELD_SHARE = 1e-3, 0.9


def _jax_grads(mus):
    """Each step's JAX gradients from its first moments after each step
    (mu_t = 0.9 mu_(t-1) + 0.1 g_t), in float64, with the slack of the
    moments' fp32 rounding: [(g_t, slack_t)]."""
    grads, prev = [], np.float64(0.0)
    for mu in mus:
        mu = np.asarray(mu, np.float64)
        grads.append(((mu - 0.9 * prev) / 0.1,
                      2.0 ** -22 * (np.abs(mu) + np.abs(prev)) / 0.1))
        prev = mu
    return grads


# a gradient that is zero in exact arithmetic is rounding on both sides
# (attention's key bias: the softmax over the keys is shift invariant);
# below this everywhere, on both sides, at every step
ROUNDING_GRAD = 1e-6


def check_state(run, rounding_grads=(), float64_only=()):
    """Parameter updates (under Adam where held), optimizer state and BN
    buffers against JAX's, each tensor to SCALED_TOL of its largest entry;
    the leaves under the spec's ``frozen_prefixes`` bit-unchanged with no
    momentum on both sides; the step and the EMA.  Under Adam, the keys
    ending in one of ``rounding_grads`` have a gradient that is zero in
    exact arithmetic: both sides' are held below ROUNDING_GRAD, and Adam
    moves each entry by at most twice the learning rate a step on either
    side, whatever direction the rounding gives it; under SGD both sides'
    momentum stays below ROUNDING_GRAD a step and the leaf moves by at
    most the learning rate times that a step.  The keys starting
    with one of ``float64_only`` have an fp32 gradient too ill-conditioned
    to compare (a caller holds them in float64): here only their optimizer
    state's key set is checked."""
    state, jstate = run["state"], run["jstate"]
    trees = {"params": jax.tree_util.tree_map(np.asarray, jstate.params),
             "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                   jstate.batch_stats)}
    opt_trees = jax.tree_util.tree_map(np.asarray,
                                       _jax_opt_trees(jstate.opt_state))
    sd = state.model.state_dict()
    named = dict(state.model.named_parameters())
    frozen = tuple(run["spec"].frozen_prefixes)
    for key, (coll, path, kind) in jax_key_map(state.model).items():
        want = to_torch_layout(kind, get_leaf(trees[coll], path))
        if coll == "batch_stats":
            np.testing.assert_allclose(sd[key].numpy(), want,
                                       rtol=BUFFER_RTOL, atol=BUFFER_ATOL,
                                       err_msg=key)
            continue
        init = run["init"][key].numpy()
        kept = state.optimizer.state[named[key]]
        if key.startswith(frozen):
            # a frozen leaf: no gradient and bit-unchanged in the port, no
            # momentum (torch's SGD makes none for a parameter without a
            # gradient); bit-unchanged with a zero trace in JAX
            assert named[key].grad is None, key
            np.testing.assert_array_equal(sd[key].numpy(), init, key)
            np.testing.assert_array_equal(want, init, key)
            assert not kept, key
            for name, tree in opt_trees.items():
                assert not get_leaf(tree, path).any(), (key, name)
            continue
        assert {k for k, v in kept.items() if torch.is_tensor(v)
                and v.shape == named[key].shape} == set(opt_trees), key
        if key.startswith(tuple(float64_only)):
            continue
        held = slice(None)
        if key.endswith(tuple(rounding_grads)) and "exp_avg" not in opt_trees:
            # under SGD a rounding gradient stays rounding: each side's
            # momentum sums at most ``steps`` of them, and each step moves
            # the leaf by the learning rate times its momentum
            steps = len(run["grads"])
            got_g = np.stack([step[key] for step in run["grads"]])
            assert np.abs(got_g).max() <= ROUNDING_GRAD, key
            bound = ROUNDING_GRAD * steps
            moments = [kept[name].numpy() for name in opt_trees] + [
                to_torch_layout(kind, get_leaf(tree, path))
                for tree in opt_trees.values()]
            assert all(np.abs(m).max() <= bound for m in moments), key
            bound *= state.optimizer.param_groups[0]["lr"] * steps
            assert np.abs(sd[key].numpy() - init).max() <= bound, key
            assert np.abs(want - init).max() <= bound, key
            continue
        if "exp_avg" in opt_trees:
            got_g = np.stack([step[key] for step in run["grads"]])
            want_g, slack = map(np.stack, zip(*_jax_grads(
                [to_torch_layout(kind, get_leaf(mu, path))
                 for mu in run["jax_mu"]])))
            if key.endswith(tuple(rounding_grads)):
                assert np.abs(got_g).max() <= ROUNDING_GRAD, key
                assert np.abs(want_g).max() <= ROUNDING_GRAD, key
                bound = 2 * state.optimizer.param_groups[0]["lr"] * len(
                    run["grads"])
                assert np.abs(sd[key].numpy() - init).max() <= bound, key
                assert np.abs(want - init).max() <= bound, key
                continue
            held = (np.abs(got_g - want_g)
                    <= ADAM_GRAD_RTOL * np.abs(want_g) + slack).all(axis=0)
            assert held.mean() >= ADAM_HELD_SHARE, (key, held.mean())
        _scaled_close((sd[key].numpy() - init)[held], (want - init)[held],
                      SCALED_TOL, key, atol=PARAM_ULPS * np.abs(want).max())
        for name, tree in opt_trees.items():
            _scaled_close(kept[name].numpy(),
                          to_torch_layout(kind, get_leaf(tree, path)),
                          SCALED_TOL, f"{key} {name}")
    assert state.step == int(jstate.step) == 2
    assert state.lr_metric_name == jstate.lr_metric_name
    np.testing.assert_allclose(state.ema.numpy(), np.asarray(jstate.ema),
                               rtol=0, atol=EMA_ATOL)
    if run["spec"].contract == "ensemble":
        assert not state.ema.any()  # the ensemble keeps no EMA


def check_qmf_tables(run):
    state, jstate = run["state"], run["jstate"]
    if run["spec"].contract != "qmf":
        assert state.qmf_correctness is None and jstate.qmf_correctness is None
        return
    for name in ("qmf_correctness", "qmf_confidence"):
        got, want = getattr(state, name), np.asarray(getattr(jstate, name))
        assert got.shape == want.shape == (2, N_TRAIN)
        np.testing.assert_allclose(got.numpy(), want, rtol=TABLE_RTOL,
                                   atol=TABLE_ATOL, err_msg=name)
        # written at the batches' real idx only
        seen = np.concatenate([b["idx"][b["valid"] > 0]
                               for b in run["batches"]])
        untouched = np.setdiff1d(np.arange(N_TRAIN), seen)
        if run["spec"].qmf_ablate_train:
            assert not got.any()
        else:
            assert (got.numpy()[:, seen] != 0).all()
            assert not got.numpy()[:, untouched].any()


def eval_on_jax_weights(run):
    """The port's eval step on the JAX run's final weights and BN
    statistics (a copy of the port's net), on the eval batch: the eval
    step's own arithmetic, apart from the two trainings' drift."""
    import copy

    model = copy.deepcopy(run["state"].model)
    jstate = run["jstate"]
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray,
                                                     jstate.params),
                       jax.tree_util.tree_map(np.asarray,
                                              jstate.batch_stats))
    state = dataclasses.replace(run["state"], model=model)
    out = make_eval_step(run["spec"])(state, _to_port(run["batches"][-1]))
    return {k: v.numpy() for k, v in out.items()}


def check_eval(run, out=None):
    """The eval outputs (``out``, by default the port's after its own
    training) against the JAX eval step's."""
    out = run["out"] if out is None else out
    jout = run["jout"]
    assert set(out) == set(jout)
    np.testing.assert_allclose(out["logits_stack"], jout["logits_stack"],
                               rtol=1e-5, atol=1e-5)
    for key in out:
        if key in CONTINUOUS:
            np.testing.assert_allclose(out[key], jout[key], rtol=LOSS_RTOL,
                                       err_msg=key)
        elif key != "logits_stack":
            np.testing.assert_array_equal(out[key], jout[key], err_msg=key)
