"""Shared harness of ``test_torch_port_{avmnist,mimic,mustard}.py``: one
model type of one benchmark, trained for two steps and evaluated once by
the JAX package and by the port from the same weights and inputs, on the
CPU, in fp32, at the benchmark's published per-sample geometry.

It is ``torch_port_contract_harness.run_pair`` for nets that take their
features as they are (no device preprocess, no random draw but OGM-GE's,
whose modulation the MIMIC nets make a no-op: they have no 4-D
parameter).  Its result carries that harness's keys, so its
``check_train_metrics``, ``check_state``, ``check_qmf_tables`` and
``check_eval`` hold it as they hold Crema-D's.  The flax init is compiled
once per benchmark (``_cached_init``, without XLA's backend
optimisations): every model type of a benchmark builds the same net.

The first train batch is full, the second has a padded tail (the loader
repeats the last real row, ``idx`` included), which the QMF scatter must
drop; the eval batch is the second.

Food101 runs its SigLIP towers at ``SIGLIP_TINY`` on both sides (the
geometry of ``test_siglip_parity.py``; the JAX net looks ``SigLIPModel``
up in ``models/siglip.py`` when called, the port's when built, so both
names are patched there) over 16 token ids and 32 x 32 pixels, with its
heads' four dropouts injected.

Food101's legacy pair (``food101_legacy``, the ``food101`` module's
jprobas types) runs its ResNet50 and BERT narrowed through the config's
own keys (``LEGACY_TINY``: stages (1, 1), two 32-wide BERT layers of 4
heads over a 200-id vocabulary) over 32 x 32 images and 16 token ids,
with BERT's dropouts, the attention weights' included, injected.

Enrico and FakeNews (``fakenews`` for the token variants,
``fakenews_embed`` for the embed ones) run narrowed on both sides
(``narrow``: ResNets at width 16 with one block a stage, the VGG stack at
an eighth of its widths, one Bottleneck block a stage, small images) and carry uint8 images or
token ids (each id row padded at its tail, the second row all padding).
Their dropout masks are injected: flax's ``jax.random.bernoulli`` (in
``flax.linen.stochastic``'s namespace) and the port's train-step mask
source both return ``dropout_mask(i % n, shape)`` for the i-th dropout
the forward reaches, n the net's dropout count, in the JAX (NHWC) layout
(the JAX step traces once, so both steps draw the same masks on both
sides); flax's attention-weight dropout draws from ``jax.random`` in
``flax.linen.attention``'s namespace, patched the same way.  A frozen tower's parameters get no gradient in the port.
"""

from __future__ import annotations

import functools
import importlib
from types import SimpleNamespace

import flax.linen.attention as flax_attention
import flax.linen.stochastic as flax_stochastic

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.engine.state import (
    create_train_state as jax_create_train_state,
)
from multimodal_clinical_tpu.engine.steps import (
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step,
)
from multimodal_clinical_tpu.data import synthetic as jax_syn
from multimodal_clinical_tpu.models import pretrained as jax_pretrained
from multimodal_clinical_tpu.models import siglip as jax_siglip
from multimodal_clinical_tpu.models import zoo as jax_zoo
from multimodal_clinical_tpu.models.resnet import (
    BottleneckResNetEncoder as JaxBottleneckEncoder,
    ResNetEncoder as JaxResNetEncoder,
)
from multimodal_clinical_tpu_torch.benchmarks import enrico as port_enrico
from multimodal_clinical_tpu_torch.benchmarks import fakenews as port_fakenews
from multimodal_clinical_tpu_torch.data import synthetic as port_syn
from multimodal_clinical_tpu_torch.engine.state import create_train_state
from multimodal_clinical_tpu_torch.engine.steps import (
    make_eval_step, make_train_step,
)
from multimodal_clinical_tpu_torch.algos.ogm_ge import modulated_parameters
from multimodal_clinical_tpu_torch.models import pretrained as port_pretrained
from multimodal_clinical_tpu_torch.models import siglip as port_siglip
from multimodal_clinical_tpu_torch.models import zoo as port_zoo
from multimodal_clinical_tpu_torch.models.common import Dropout
from multimodal_clinical_tpu_torch.models.jax_weights import (
    load_jax_variables,
)
from multimodal_clinical_tpu_torch.models.resnet import (
    BottleneckResNetEncoder, ResNetEncoder,
)
from torch_port_contract_harness import (
    B, FAST_INIT, N_TRAIN, VALID_TAIL, _cached_init, _jax_opt_trees,
    _Namespace, _to_jax, _to_port, patch_ogm_normal,
)

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# per benchmark: (classes, per-sample shapes, learning rate, data seed);
# AV-MNIST's inputs are pixel values / 255; a shape ("u8", shape) is uint8
# pixels, ("ids", L) token ids, ("unit", shape) floats in [0, 1].  Two
# fp32 implementations part where a ReLU or max-pool decision sits within
# rounding of its threshold (torch_port_contract_harness.py): AV-MNIST's
# numpy seed 0 crosses one at step 1 (losses 1.8e-5 apart), seeds 1-3
# none; MIMIC's and MUsTARD's seeds 0-2 none; Enrico's seeds 0-2 none
# (at width 8, seed 0 crossed one under ensemble_vicreg)
SMALL_IMAGE = (64, 32, 3)
BENCHMARKS = {
    "avmnist": (10, [("unit", (28, 28, 1)), ("unit", (112, 112, 1))], 1e-2,
                1),
    "mimic": (6, [(5,), (24, 12)], 1e-2, 0),
    "mustard": (2, [(40, 371), (40, 81), (40, 300)], 5e-4, 0),
    "enrico": (20, [("u8", SMALL_IMAGE), ("u8", SMALL_IMAGE)], 1e-2, 0),
    "fakenews": (6, [("ids", 12), ("unit", (64, 64, 3)), ("ids", 12)], 1e-2,
                 0),
    "fakenews_embed": (6, [(768,), (32, 32, 3), (768,)], 1e-2, 0),
    "food101": (101, [("ids", 16), (32, 32, 3)], 2e-2, 0),
    "food101_legacy": (101, [(32, 32, 3), ("ids", 16)], 2e-2, 0),
}
MODULES = {"fakenews_embed": "fakenews", "food101_legacy": "food101"}
# the narrowed VGG11Slim stack (an eighth of torchvision's widths)
NARROW_VGG = (8, "M", 16, "M", 32, 32, "M", 64, 64, "M", 64, 64, "M")
TEXT_VOCAB = 200
# the narrowed SigLIP (tests/test_siglip_parity.py's _TINY)
SIGLIP_TINY = dict(width=64, layers=2, heads=2, mlp_dim=128, patch=16,
                   image_size=32, text_len=16, vocab=1000)
# the narrowed legacy towers, through the config's keys (the geometry of
# tests/test_food101_legacy.py)
LEGACY_TINY = dict(legacy_stages=(1, 1), legacy_bert_layers=2,
                   legacy_bert_width=32, legacy_bert_heads=4,
                   legacy_bert_vocab=TEXT_VOCAB, max_seq_len=16)


# the narrowed ResNets' stem width
WIDTH = 16
# the embed net's Bottleneck stem width: at 64 its fp32 gradient parts
# from JAX's by 1.4% of the largest entry already at the first step (in
# float64 the two agree to 1e-13): its ~10^6 ReLU inputs, BN-normalised
# over a few values each, put some within the frameworks' rounding of
# zero at every data seed tried (0-9, images of 32 to 128 pixels)
BOTTLENECK_WIDTH = 8


def _jax_one_block(**kw):
    """ResNet18Slim's encoder at ``WIDTH`` with one block a stage (it
    names its (2, 2, 2, 2) stages), as the contract harness's towers."""
    return JaxResNetEncoder(**{**kw, "stage_sizes": (1, 1, 1, 1),
                               "width": WIDTH})


def _port_one_block(in_channels, stage_sizes, width, **kw):
    return ResNetEncoder(in_channels, (1, 1, 1, 1), width, **kw)


def narrow(bench, mp):
    """The narrowed towers and twins of ``bench`` on both sides."""
    if bench == "enrico":
        mp.setattr(jax_pretrained, "ResNetEncoder", _jax_one_block)
        mp.setattr(port_pretrained, "ResNetEncoder", _port_one_block)
        mp.setattr(port_enrico, "EnricoFusionNet",
                   functools.partial(port_zoo.EnricoFusionNet, width=WIDTH))
        for mod in (jax_pretrained, port_pretrained):
            mp.setattr(mod, "_VGG11_CFG", NARROW_VGG)
        # the CLI's twin (bf16): PyTorch's CPU bf16 channels_last 3x3/s2
        # conv gives NaN on 4 x 2 maps (21 of 100 draws at 128 -> 256
        # channels), which 64 x 32 screens put before layer4; 128 x 64
        # puts 8 x 4 there, which gave none
        shapes = {"enrico": [(128, 64, 3), (128, 64, 3)]}
    elif bench == "fakenews":
        mp.setattr(jax_zoo, "ResNetEncoder", functools.partial(
            JaxResNetEncoder, width=WIDTH, stage_sizes=(1, 1, 1, 1)))
        mp.setattr(port_zoo, "ResNetEncoder", functools.partial(
            ResNetEncoder, stage_sizes=(1, 1, 1, 1)))
        mp.setattr(port_fakenews, "FakeNewsFusionNet",
                   functools.partial(port_zoo.FakeNewsFusionNet, width=WIDTH))
        shapes = {"fakenews": [(12,), (32, 32, 3)],
                  "fakenews_dialogue": [(12,), (32, 32, 3), (12,)]}
    elif bench == "food101":
        for mod in (jax_siglip, port_siglip):
            mp.setattr(mod, "SigLIPModel", functools.partial(
                mod.SigLIPModel, **SIGLIP_TINY))
        shapes = {"food101": [(16,), (32, 32, 3)]}
    elif bench == "food101_legacy":
        shapes = {"food101_legacy": [(32, 32, 3), (16,)]}
    elif bench == "fakenews_embed":
        for mod, enc in ((jax_zoo, JaxBottleneckEncoder),
                         (port_zoo, BottleneckResNetEncoder)):
            mp.setattr(mod, "BottleneckResNetEncoder",
                       functools.partial(enc, width=BOTTLENECK_WIDTH))
        shapes = {"fakenews_embed": [(768,), (32, 32, 3)],
                  "fakenews_embed_dialogue": [(768,), (32, 32, 3), (768,)]}
    else:
        return
    for name, shape in shapes.items():
        for mod in (jax_syn, port_syn):
            mp.setitem(mod.BENCHMARK_SHAPES, name, shape)


def _modality(rng, kind):
    if kind[0] == "u8":
        return rng.integers(0, 256, size=(B,) + kind[1], dtype=np.uint8)
    if kind[0] == "ids":
        ids = rng.integers(1, TEXT_VOCAB, size=(B, kind[1])).astype(np.int32)
        lengths = rng.integers(1, kind[1] + 1, size=B)
        lengths[1] = 0  # a row of padding only
        ids[np.arange(kind[1]) >= lengths[:, None]] = 0
        return ids
    if kind[0] == "unit":
        return rng.random((B,) + kind[1]).astype(np.float32)
    return rng.normal(size=(B,) + kind).astype(np.float32)


def batches(bench: str):
    """Two train batches (the second with a padded tail) as numpy dicts."""
    classes, shapes, _, data_seed = BENCHMARKS[bench]
    rng = np.random.default_rng(data_seed)
    ids = rng.permutation(N_TRAIN)
    out = []
    for step, real in enumerate((B, VALID_TAIL)):
        rows = np.arange(B).clip(max=real - 1)  # repeat the last real row
        batch = {}
        for i, kind in enumerate(shapes):
            batch[f"x{i + 1}"] = _modality(rng, kind)[rows]
        batch["label"] = rng.integers(0, classes, size=B)[rows]
        batch["idx"] = ids[step * B:(step + 1) * B][rows]
        batch["valid"] = (np.arange(B) < real).astype(np.float32)
        out.append(batch)
    return out


def _module_name(bench: str) -> str:
    return MODULES.get(bench, bench)


def _args(bench: str, model_type: str, **overrides):
    classes, _, lr, _ = BENCHMARKS[bench]
    args = dict(num_classes=classes, batch_size=B, learning_rate=lr,
                num_epochs=60, use_scheduler=False, seed=0,
                compute_dtype="float32", model_type=model_type)
    if bench == "fakenews_embed":
        args["embed_stage_sizes"] = (1, 1, 1, 1)
    if bench == "food101_legacy":
        args.update(LEGACY_TINY)
    return SimpleNamespace(**{**args, **overrides})


def dropout_mask(i: int, shape, keep_prob: float) -> np.ndarray:
    """The i-th dropout's keep mask, in the JAX layout."""
    return np.random.default_rng(500 + i).random(shape) < keep_prob


def count_dropouts(model) -> int:
    """The dropouts ``model``'s train-mode forward draws: its ``Dropout``
    modules and its attentions with a dropout rate."""
    return sum(isinstance(m, Dropout)
               or getattr(m, "dropout_rate", 0.0) > 0.0
               for m in model.modules())


def patch_dropout(mp, n: int, nchw: bool = True):
    """flax's dropout draws (``nn.Dropout``'s and the attention weights')
    and the port's train-step mask source, both returning
    ``dropout_mask(i % n, ...)``; a 4-D port mask is an NCHW map when
    ``nchw``, drawn as its NHWC twin (else, as BERT's (1, 1, L, L)
    attention masks, in the same layout on both sides); returns (the
    port's ``make_train_step(dropout=...)`` argument, the draws of each
    side as {"jax"|"port": [(shape, keep_prob), ...]})."""
    drawn = {"jax": [], "port": []}

    def bernoulli(key, p=0.5, shape=None):
        i = len(drawn["jax"])
        drawn["jax"].append((tuple(shape), float(p)))
        return jnp.asarray(dropout_mask(i % n, tuple(shape), float(p)))

    for mod in (flax_stochastic, flax_attention):
        mp.setattr(mod, "random", _Namespace(jax.random,
                                             bernoulli=bernoulli))
    permute = lambda shape: nchw and len(shape) == 4

    def per_step(state):
        count = [0]

        def source(shape, keep_prob, device):
            jshape = ((shape[0], *shape[2:], shape[1]) if permute(shape)
                      else tuple(shape))
            drawn["port"].append((jshape, float(keep_prob)))
            mask = torch.from_numpy(dropout_mask(count[0] % n, jshape,
                                                 keep_prob))
            count[0] += 1
            if permute(shape):
                mask = mask.permute(0, 3, 1, 2)
            return mask.to(device)

        return source

    return per_step, drawn


def run_pair(bench: str, model_type: str, **arg_overrides):
    """Both sides' per-step metrics, eval outputs and final state, in the
    keys of ``torch_port_contract_harness.run_pair``'s result."""
    with pytest.MonkeyPatch.context() as mp:
        narrow(bench, mp)
        return _run_pair(bench, model_type, **arg_overrides)


def _run_pair(bench: str, model_type: str, **arg_overrides):
    name = _module_name(bench)
    port_mod = importlib.import_module(
        f"multimodal_clinical_tpu_torch.benchmarks.{name}")
    jax_mod = importlib.import_module(
        f"multimodal_clinical_tpu.benchmarks.{name}")
    args = _args(bench, model_type, **arg_overrides)
    data = batches(bench)
    jspec, jopt = jax_mod.get_model_spec(args, n_train=N_TRAIN)
    spec, opt = port_mod.get_model_spec(args, n_train=N_TRAIN)
    n_in = spec.num_inputs or spec.num_modality
    sample = [jnp.asarray(data[0][f"x{i + 1}"][:2]) for i in range(n_in)]
    net = type(jspec.module)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(net, "init", _cached_init(f"{bench} {net.__name__} {n_in}",
                                             net.init, FAST_INIT))
        jstate = jax_create_train_state(jspec, args, jax.random.PRNGKey(0),
                                        sample, steps_per_epoch=100, **jopt)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    stats = jax.tree_util.tree_map(np.asarray, jstate.batch_stats)
    state = create_train_state(spec, args, seed=0, steps_per_epoch=100,
                               device="cpu", **opt)
    load_jax_variables(state.model, params, stats)
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    n_dropouts = count_dropouts(state.model)
    attention_dropout = any(getattr(m, "dropout_rate", 0.0) > 0.0
                            for m in state.model.modules())

    calls = []
    with pytest.MonkeyPatch.context() as mp:
        def normal(key, shape, dtype=jnp.float32):
            calls.append(shape)
            return jnp.zeros(shape, dtype)

        patch_ogm_normal(mp, normal)
        dropout, dropped = patch_dropout(mp, max(n_dropouts, 1),
                                         nchw=not attention_dropout)
        jtrain, jeval = jax_make_train_step(jspec), jax_make_eval_step(jspec)
        train = make_train_step(spec, dropout=dropout)
        evaluate = make_eval_step(spec)
        metrics, jmetrics, grads, jax_mu = [], [], [], []
        for batch in data:
            state, m = train(state, _to_port(batch))
            metrics.append({k: float(v) for k, v in m.items()})
            # a frozen tower's parameters get no gradient
            grads.append({k: p.grad.numpy().copy() for k, p in
                          state.model.named_parameters()
                          if p.grad is not None})
            jstate, jm = jtrain(jstate, _to_jax(batch))
            jmetrics.append({k: float(v) for k, v in jm.items()})
            jax_mu.append(jax.tree_util.tree_map(
                np.array, _jax_opt_trees(jstate.opt_state).get("exp_avg")))
        out = {k: v.numpy() for k, v in evaluate(
            state, _to_port(data[-1])).items()}
        jout = {k: np.asarray(v) for k, v in jeval(
            jstate, _to_jax(data[-1])).items()}
    # the port's OGM walk: the 4-D leaves under the modality encoders
    has_conv = any(True for _ in modulated_parameters(state.model))
    return dict(spec=spec, jspec=jspec, opt=opt, jopt=jopt, state=state,
                jstate=jstate, init=init, metrics=metrics,
                jmetrics=jmetrics, grads=grads, jax_mu=jax_mu, out=out,
                jout=jout, dropped=dropped, n_dropouts=n_dropouts,
                noise_calls=len(calls),
                modulated=bool(jspec.apply_grad_mod and jspec.grad_mod_type
                               and jspec.grad_mod_type != "OGM"
                               and has_conv),
                batches=data, drawn={"jax": [], "port": []}, masked=False)


def spec_equal_jax(bench, model_type):
    """Both packages' spec fields and optimizer arguments."""
    from torch_port_contract_harness import spec_fields

    name = _module_name(bench)
    port_mod = importlib.import_module(
        f"multimodal_clinical_tpu_torch.benchmarks.{name}")
    jax_mod = importlib.import_module(
        f"multimodal_clinical_tpu.benchmarks.{name}")
    args = _args(bench, model_type)
    spec, opt = port_mod.get_model_spec(args, n_train=N_TRAIN)
    jspec, jopt = jax_mod.get_model_spec(args, n_train=N_TRAIN)
    # the frozen prefixes name each package's own module paths
    # (test_torch_port_enrico.py maps one onto the other)
    got, want = spec_fields(spec), spec_fields(jspec)
    assert bool(got.pop("frozen_prefixes")) == bool(
        want.pop("frozen_prefixes"))
    assert got == want
    assert opt == jopt
    assert type(spec.module).__name__ == type(jspec.module).__name__


def gather_equal(got, want):
    """Two DataBundles equal field by field and row by row, bit for bit."""
    for field in ("train_sampler", "val_sampler", "test_sampler",
                  "synthetic"):
        assert getattr(got, field) == getattr(want, field), field
    for split in ("train", "val", "test"):
        a, b = getattr(got, split), getattr(want, split)
        assert len(a) == len(b), split
        ga, gb = a.gather(np.arange(len(b))), b.gather(np.arange(len(b)))
        assert set(ga) == set(gb)
        for k in gb:
            assert ga[k].dtype == gb[k].dtype, (split, k)
            np.testing.assert_array_equal(ga[k], gb[k], err_msg=(split, k))


# -- the CLI -------------------------------------------------------------------

# the CLI settings that narrow a benchmark beyond ``narrow``
CLI_SETS = {"fakenews_embed": ("--set", "embed_stage_sizes=[1, 1, 1, 1]"),
            "food101_legacy": tuple(
                a for k, v in LEGACY_TINY.items() for a in (
                    "--set", f"{k}={list(v) if isinstance(v, tuple) else v}"))}


def cli_argv(bench, root, model_type, *extra):
    return ["--dir", _module_name(bench), "--set", f"model_type={model_type}",
            "--set", "num_epochs=2", "--set", "log_every_n_steps=2",
            "--set", f"ckpt_dir={root}", "--set", f"data_path={root}/none",
            *CLI_SETS.get(bench, ()), *extra]


def metrics_rows(root):
    """The rows of the one ``metrics.jsonl`` under ``root``."""
    import json
    from pathlib import Path

    (path,) = Path(root).glob("*/metrics.jsonl")
    return [json.loads(line) for line in path.read_text().splitlines()]


def row_kind(row):
    for prefix in ("train_step", "val_step", "test_step"):
        if any(k.startswith(prefix + "/") for k in row):
            return prefix
    return "test_epoch" if row.get("epoch") == -1 else "epoch"


def cli_pair(bench, model_type, root, *extra):
    """The JAX CLI and the port's (on the CPU), in process, on the
    benchmark's twin, ``extra`` arguments given to both: {"jax"|"port":
    (summary, metrics rows)}."""
    import multimodal_clinical_tpu.__main__ as jax_main
    from multimodal_clinical_tpu.engine import checkpoint as jax_checkpoint
    import multimodal_clinical_tpu_torch.__main__ as port_main

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        narrow(bench, mp)
        jspec = importlib.import_module(
            f"multimodal_clinical_tpu.benchmarks.{_module_name(bench)}"
        ).get_model_spec(_args(bench, model_type), n_train=N_TRAIN)[0]
        net = type(jspec.module)
        n_in = jspec.num_inputs or jspec.num_modality
        # the flax init compiled: op by op it takes longer than the run
        mp.setattr(net, "init", _cached_init(
            f"{bench} {net.__name__} {n_in} cli", net.init, FAST_INIT))
        # the JAX run's checkpoints are not read: msgpack, not orbax,
        # whose import alone takes seconds
        mp.setattr(jax_checkpoint, "_default_backend", lambda: "msgpack")
        for side, main, kwargs in (("jax", jax_main, {}),
                                   ("port", port_main, {"device": "cpu"})):
            summary = main.run_training(
                cli_argv(bench, root / side, model_type, *extra), **kwargs)
            out[side] = (summary, metrics_rows(root / side))
    return out


def check_cli_keys(runs):
    """The same summary keys and, per row kind, the same metrics.jsonl
    keys in the same order of rows."""
    (summary, rows), (jsummary, jrows) = runs["port"], runs["jax"]
    assert set(summary) == set(jsummary)
    for kind in ("train_step", "val_step", "test_step", "epoch",
                 "test_epoch"):
        got = [sorted(r) for r in rows if row_kind(r) == kind]
        want = [sorted(r) for r in jrows if row_kind(r) == kind]
        assert got and got == want, kind
    return rows


def resume_one_more_epoch(bench, model_type, root):
    """``--resume`` with one more epoch on the port's run under ``root``:
    the restored state (weights, optimizer state, EMA, QMF tables) equals
    the saved last checkpoint, and exactly one more epoch trains.  Returns
    the saved state."""
    import copy
    import os
    from pathlib import Path

    import multimodal_clinical_tpu_torch.__main__ as port_main
    import multimodal_clinical_tpu_torch.engine.run as port_run

    (ckpt,) = Path(root).glob("*/ckpt")
    _, last = max((int(n.split("-")[1]), n) for n in os.listdir(ckpt)
                  if n.startswith("last-"))
    saved = torch.load(ckpt / last / "state.pt", weights_only=True)
    seen = {}

    class Watched(port_run.Trainer):
        def resume(self):
            found = super().resume()
            st = self.state
            seen.update(copy.deepcopy(dict(
                step=st.step, model=st.model.state_dict(),
                optimizer=st.optimizer.state_dict(), ema=st.ema,
                qmf=(st.qmf_correctness, st.qmf_confidence))))
            return found

    with pytest.MonkeyPatch.context() as mp:
        narrow(bench, mp)
        mp.setattr(port_run, "Trainer", Watched)
        port_main.run_training(cli_argv(bench, root, model_type, "--resume",
                                        "--set", "num_epochs=3"),
                               device="cpu")
    assert seen["step"] == saved["step"]
    for k, v in saved["model"].items():
        assert torch.equal(seen["model"][k], v), k
    assert torch.equal(seen["ema"], saved["ema"])
    opt = seen["optimizer"]["state"]
    assert opt.keys() == saved["optimizer"]["state"].keys()
    for i, kept in saved["optimizer"]["state"].items():
        for name, value in kept.items():
            if torch.is_tensor(value):
                assert torch.equal(opt[i][name], value), (i, name)
    rows = metrics_rows(root)
    assert [r["epoch"] for r in rows if row_kind(r) == "epoch"][-3:] == [
        0, 1, 2]
    return saved, seen


def preempted_run_resumes_bit_equal(bench, model_type, root, after=2):
    """SIGTERM after ``after`` train batches of epoch 0, then ``--resume``:
    weights, buffers, optimizer state, EMA, step and QMF tables end
    bit-equal to an uninterrupted two-epoch run's."""
    with pytest.MonkeyPatch.context() as mp:
        narrow(bench, mp)
        return _preempted_run_resumes_bit_equal(bench, model_type, root,
                                                after)


def _preempted_run_resumes_bit_equal(bench, model_type, root, after):
    import os
    import signal

    from multimodal_clinical_tpu_torch.config import load_config
    import multimodal_clinical_tpu_torch.engine.run as port_run
    from multimodal_clinical_tpu_torch.engine.trainer import (
        Preempted, Trainer,
    )

    name = _module_name(bench)
    module = importlib.import_module(
        f"multimodal_clinical_tpu_torch.benchmarks.{name}")
    extra = {"embed_stage_sizes": (1, 1, 1, 1)} if "embed" in bench else {}

    def trainer(where):
        args = load_config(name, overrides=dict(
            model_type=model_type, num_epochs=2, log_every_n_steps=2,
            ckpt_dir=str(where), data_path=f"{where}/none", **extra))
        data = module.get_data(args)
        spec, opt = module.get_model_spec(args, n_train=len(data.train))
        loaders = port_run.build_loaders(args, data, "cpu")
        state = create_train_state(spec, args, int(args.seed),
                                   len(loaders[0]), device="cpu", **opt)
        return Trainer(args, spec, state, *loaders)

    class InterruptAfter:
        def __init__(self, inner):
            self.inner = inner

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def __len__(self):
            return len(self.inner)

        def __iter__(self):
            for i, b in enumerate(self.inner):
                if i == after:
                    os.kill(os.getpid(), signal.SIGTERM)
                yield b

    ref = trainer(root / "ref")
    ref.fit()
    pre = trainer(root / "pre")
    pre.train_loader = InterruptAfter(pre.train_loader)
    with pytest.raises(Preempted) as exc:
        pre.fit()
    assert exc.value.code == 143 and exc.value.step == after + 1
    resumed = trainer(root / "pre")
    assert resumed.resume() and resumed.state.step == after + 1
    resumed.fit()
    a, b = resumed.state, ref.state
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa = a.optimizer.state_dict()["state"]
    ob = b.optimizer.state_dict()["state"]
    assert oa.keys() == ob.keys()
    for i in oa:
        for name, value in oa[i].items():
            if torch.is_tensor(value):
                assert torch.equal(value, ob[i][name]), (i, name)
    assert torch.equal(a.ema, b.ema) and a.step == b.step
    for name in ("qmf_correctness", "qmf_confidence"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None and y is None) or torch.equal(x, y)
    return a
