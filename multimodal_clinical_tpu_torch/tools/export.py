"""Serving export (port of the JAX package's ``tools/export.py``): a
trained model as a ``torch.export`` program with its weights embedded.

The exported function is the eval-mode forward of raw inputs, including
the benchmark's ``device_preprocess`` (VGGSound's log-STFT, which runs as
the registered operator ``mmct::log_spectrogram`` and, on the card, the
``csrc/log_spectrogram.cu`` kernel inside the program) and the contract's
eval fusion (jprobas fuses the mean probability, every other contract the
plain logits mean; MIMIC's w1/w2 weighting is train-only):

    python -m multimodal_clinical_tpu_torch.tools.export --dir mimic \\
        --ckpt data/mimic_ckpts/<g>/ckpt [--which best|last] [--batch 8|sym]
        [--out <dir>] [--device cuda|cpu]

Artifact layout:
    <out>/serving.pt2   ``torch.export.save`` of the program (weights in it)
    <out>/meta.json     input signature, contract, provenance, and the port
                        module whose import registers the program's
                        operators (``op_module``)

Loading (this package installed, no checkpoint or config needed):
    from multimodal_clinical_tpu_torch.tools.export import load_artifact
    serve = load_artifact("<out>")
    out = serve(x1, x2)   # {"logprobs", "pred", "logits_stack"}

``--batch sym`` exports a batch-polymorphic program (``torch.export.Dim``).
The program runs on the device it was exported on: CUDA unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..engine import contracts as C
from ..engine.steps import _model_inputs
from ..ops import cuda_spectrogram
from ..utils.device import resolve_device
from .predict import config_from, prob_fusion, restore_state


class ServingProgram(nn.Module):
    """Eval-mode forward and contract fusion as a function of the raw
    modality inputs (the loader batch keys ``input_keys``, e.g.
    ``x1_waveform`` where the DSP runs on the device); the weights are the
    wrapped model's, so ``torch.export`` embeds them."""

    def __init__(self, spec, model: nn.Module, input_keys):
        super().__init__()
        self.spec = spec
        self.model = model.eval()
        self.input_keys = list(input_keys)
        self.prob_fusion = prob_fusion(spec)

    def forward(self, *inputs):
        batch = dict(zip(self.input_keys, inputs))
        n, device = inputs[0].shape[0], inputs[0].device
        batch["label"] = torch.zeros(n, dtype=torch.int64, device=device)
        batch["valid"] = torch.ones(n, dtype=torch.float32, device=device)
        batch["idx"] = torch.arange(n, dtype=torch.int64, device=device)
        if self.spec.device_preprocess is not None:
            batch = self.spec.device_preprocess(batch, None, False)
        logits = self.model(*_model_inputs(batch, self.spec))["logits"]
        # the eval step's logits_stack: per-modality log-probabilities
        # under jprobas, raw logits otherwise, so artifact consumers and
        # predict agree
        report = C.to_logprobs(logits) if self.prob_fusion else logits
        stack = torch.stack([r.float() for r in report], dim=1)
        if self.prob_fusion:
            logp = F.log_softmax(C.fuse_probas(logits), dim=-1)
        else:
            logp = F.log_softmax(C.fuse_logits(logits).float(), dim=-1)
        return {"logprobs": logp,
                "pred": logp.argmax(dim=-1).to(torch.int32),
                "logits_stack": stack}


def input_signature(spec, data):
    """(keys, [(per-row shape, numpy dtype)], sample rows) of the raw
    per-modality inputs, from up to two real (or twin) test samples so the
    export matches the loader."""
    sample = data.test.gather(np.arange(min(2, len(data.test))))
    keys, sig = [], []
    for i in range(spec.num_inputs or spec.num_modality):
        wf = f"x{i + 1}_waveform"
        key = wf if wf in sample else f"x{i + 1}"
        keys.append(key)
        rows = np.asarray(sample[key])
        sig.append((tuple(rows.shape[1:]), rows.dtype))
    return keys, sig, sample


def example_inputs(keys, sample, batch: int, device):
    """``batch`` rows of each input, the sample's rows repeated."""
    out = []
    for key in keys:
        rows = np.asarray(sample[key])
        out.append(torch.from_numpy(
            np.resize(rows, (batch, *rows.shape[1:]))).to(device))
    return tuple(out)


def export_benchmark(args, benchmark, ckpt_dir, which, batch, out_dir,
                     device="cuda"):
    device = resolve_device(device)
    if ckpt_dir:
        data, spec, state = restore_state(args, benchmark, ckpt_dir, which,
                                          device)
    else:
        from ..engine.state import create_train_state

        print("[export] WARNING: no --ckpt given, exporting fresh-init "
              "weights (shape/pipeline artifact only)")
        data = benchmark.get_data(args)
        spec, opt_kwargs = benchmark.get_model_spec(args,
                                                    n_train=len(data.train))
        state = create_train_state(spec, args, int(getattr(args, "seed", 0)),
                                   1, device=device, **(opt_kwargs or {}))
    symbolic = batch == "sym"
    keys, sig, sample = input_signature(spec, data)
    inputs = example_inputs(keys, sample, 2 if symbolic else int(batch),
                            device)
    dynamic = None
    if symbolic:
        b = torch.export.Dim("b", min=1)
        # one entry per argument of forward: the *inputs tuple
        dynamic = (tuple({0: b} for _ in inputs),)
    with torch.no_grad():
        program = torch.export.export(
            ServingProgram(spec, state.model, keys), inputs,
            dynamic_shapes=dynamic, strict=False)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "serving.pt2")
    torch.export.save(program, path)
    meta = {
        "benchmark": args.dir,
        "model_type": getattr(args, "model_type", None),
        "contract": spec.contract,
        "num_classes": int(args.num_classes),
        "batch": batch,  # "sym" = batch-polymorphic
        "platforms": [device.type],
        "checkpoint": ckpt_dir or None,
        "inputs": [{"name": k,
                    "shape": ["b" if symbolic else int(batch), *shape],
                    "dtype": str(np.dtype(dtype))}
                   for k, (shape, dtype) in zip(keys, sig)],
        "outputs": ["logprobs", "pred", "logits_stack"],
        "logits_stack_semantics": ("per_modality_logprobs"
                                   if prob_fusion(spec)
                                   else "per_modality_logits"),
        "op_module": cuda_spectrogram.__name__,
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    print(f"[export] {os.path.getsize(path) / 1e6:.1f} MB artifact -> "
          f"{out_dir} (device {device})")
    return out_dir


def load_artifact(out_dir: str):
    """The served program of an artifact as a callable(*inputs); imports
    the module that registers its operators first."""
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    importlib.import_module(meta["op_module"])
    program = torch.export.load(os.path.join(out_dir, "serving.pt2"))
    module = program.module()

    def serve(*inputs):
        with torch.no_grad():
            return module(*inputs)

    return serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir (the trainer's <run_dir>/ckpt)")
    ap.add_argument("--which", choices=("best", "last"), default="best")
    ap.add_argument("--batch", default="8",
                    help="export batch size, or 'sym' for a "
                         "batch-polymorphic artifact")
    ap.add_argument("--out", default=None,
                    help="artifact dir (default <ckpt|.>/serving_<ds>)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--set", action="append", default=[], metavar="k=v")
    a = ap.parse_args(argv)

    from ..benchmarks import get_benchmark

    args = config_from(a)
    out_dir = a.out or os.path.join(a.ckpt or ".", f"serving_{args.dir}")
    return export_benchmark(args, get_benchmark(args.dir), a.ckpt, a.which,
                            a.batch, out_dir, device=a.device)


if __name__ == "__main__":
    main()
