"""Benchmark registry: ``--dir <name>`` -> benchmark module (port of
``multimodal_clinical_tpu/benchmarks/__init__.py``).

Each benchmark module exposes
    get_data(args) -> engine.run.DataBundle
    get_model_spec(args, n_train) -> (engine.spec.ModelSpec, opt_kwargs)
A benchmark may also expose ``load_pretrained(args, state)``, which
``engine/run.py`` calls between the state's init and ``init_ckpt``.  The
port serves all nine benchmarks; ``_NOT_PORTED`` maps a name still to
come to the ROADMAP.md queue A item that ports it, and is empty.
"""

from __future__ import annotations

import importlib

_REGISTRY = {"vggsound": ".vggsound", "cremad": ".cremad", "ave": ".ave",
             "avmnist": ".avmnist", "mimic": ".mimic", "mustard": ".mustard",
             "enrico": ".enrico", "fakenews": ".fakenews",
             "food101": ".food101"}

_NOT_PORTED: dict = {}


def get_benchmark(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"benchmark {name!r} is not ported yet (ROADMAP.md queue A, "
            f"item {_NOT_PORTED[name]})")
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"unknown benchmark {name!r}; known: {available()}")
    return importlib.import_module(_REGISTRY[name], package=__name__)


def available() -> list:
    return sorted([*_REGISTRY, *_NOT_PORTED])
