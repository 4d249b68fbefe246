"""The multi-seed sweep on the benchmarks whose towers
``test_torch_port_multiseed_step.py`` does not run: seed s of the sweep
against the port's single-seed run s, on the CPU, in fp32, through
``torch_port_multiseed_harness`` (its docstring gives the tolerances).

The nets and rows are ``torch_port_benchmark_harness``'s (``narrow``,
``batches``, ``_args``), seed s's rows drawn from the benchmark's data
seed + 10 s: Enrico's ResNet18 and VGG11 towers with frozen features;
FakeNews' text transformer and ResNet over three inputs (the dialogue
variant) and its Bottleneck ResNet over embeddings; MUsTARD's GRU and
LSTM loops; Food101's SigLIP towers with its heads' dropouts, under
OGM-GE and QMF; its legacy pair (frozen ResNet50, BERT with dropout on
the attention weights).  Every dropout draws from the per-seed, per-step
generators on both sides.  Two steps (the second with a padded tail),
then one eval on per-seed and on shared rows; the data seeds cross no
ReLU or max-pool threshold within fp32 rounding in these two steps.
vmap's per-sample fallback warning is an error in this file.
"""

from __future__ import annotations

import importlib

import pytest
import torch

import torch_port_benchmark_harness as BH
import torch_port_multiseed_harness as H
from torch_port_contract_harness import B, N_TRAIN, VALID_TAIL
from torch_port_multiseed_harness import (  # noqa: F401 (autouse)
    vmap_fallback_is_an_error,
)

torch.set_num_threads(2)

# the keys that the benchmark's own test holds as check_state's
# rounding_grads (attention's key bias: the softmax over the keys is shift
# invariant) and float64_only (the embed variant's Bottleneck ResNet)
ROUNDING = {"fakenews": (".key.bias",), "food101": (".k_proj.bias",)}
FLOAT64_ONLY = {"fakenews_embed": ("image_module.",)}
CASES = [("enrico", "jlogits"), ("enrico", "ensemble_vicreg"),
         ("fakenews", "jlogits_dialogue"), ("fakenews_embed", "jlogits_embed"),
         ("mustard", "jlogits"), ("mustard", "ensemble"),
         ("food101", "ogm_ge"), ("food101", "qmf"),
         ("food101_legacy", "jprobas")]


@pytest.mark.parametrize("bench,model_type", CASES,
                         ids=["-".join(c) for c in CASES])
def test_sweep_equals_single_seed_runs(bench, model_type):
    module = importlib.import_module(
        f"multimodal_clinical_tpu_torch.benchmarks.{BH._module_name(bench)}")
    classes, shapes, lr, data_seed = BH.BENCHMARKS[bench]

    def make_spec():
        args = BH._args(bench, model_type)
        spec, opt_kwargs = module.get_model_spec(args, n_train=N_TRAIN)
        return spec, opt_kwargs, args

    with pytest.MonkeyPatch.context() as mp:
        BH.narrow(bench, mp)
        data = []
        for s in range(len(H.SEEDS)):
            mp.setitem(BH.BENCHMARKS, bench,
                       (classes, shapes, lr, data_seed + 10 * s))
            data.append([H.to_torch(b) for b in BH.batches(bench)])
        singles, swept, spec = H.run_both(make_spec, data)
    H.check_seeds(singles, swept, spec, history_rows=B + VALID_TAIL,
                  rounding_grads=ROUNDING.get(bench, ()),
                  float64_only=FLOAT64_ONLY.get(bench, ()))
    if bench.startswith("food101"):
        # the dropouts ran: heads' (SigLIP) or BERT's, attention's included
        assert BH.count_dropouts(spec.module) > 0
    if spec.frozen_prefixes:
        frozen = [name for name in swept["state"].params
                  if name.startswith(spec.frozen_prefixes)]
        assert frozen and all(
            swept["state"].params[name].grad is None
            or not swept["state"].params[name].grad.any()
            for name in frozen)
