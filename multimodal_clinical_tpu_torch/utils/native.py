"""ctypes binding of the alias table in the repository's native host
library, ``native/libfastdata.so`` (port of the alias-table part of
``multimodal_clinical_tpu/utils/native.py``).

``make -C native`` builds the library (the JAX package's binding runs that
make itself); the port loads what is there and builds nothing.  When it
does not load (``OSError``: not built, or a library it links is missing),
``available()`` is False and the weighted sampler draws from numpy, as the
JAX package's sampler does where the library does not load."""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native", "libfastdata.so")

_DOUBLE_P = ctypes.POINTER(ctypes.c_double)
_INT64_P = ctypes.POINTER(ctypes.c_int64)

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError:
        return None
    lib.build_alias_table.argtypes = [_DOUBLE_P, ctypes.c_int64, _DOUBLE_P,
                                      _INT64_P]
    lib.build_alias_table.restype = None
    lib.alias_sample.argtypes = [_DOUBLE_P, _INT64_P, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_uint64, _INT64_P]
    lib.alias_sample.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


class AliasTable:
    """Vose alias table over unnormalised weights; O(1) per draw."""

    def __init__(self, weights: np.ndarray):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"{LIB_PATH} does not load")
        w = np.ascontiguousarray(weights, np.float64)
        self.n = len(w)
        self.prob = np.empty(self.n, np.float64)
        self.alias = np.empty(self.n, np.int64)
        lib.build_alias_table(w.ctypes.data_as(_DOUBLE_P), self.n,
                              self.prob.ctypes.data_as(_DOUBLE_P),
                              self.alias.ctypes.data_as(_INT64_P))

    def sample(self, num_samples: int, seed: int) -> np.ndarray:
        out = np.empty(int(num_samples), np.int64)
        _load().alias_sample(
            self.prob.ctypes.data_as(_DOUBLE_P),
            self.alias.ctypes.data_as(_INT64_P), self.n, len(out),
            ctypes.c_uint64(seed & (2 ** 64 - 1)),
            out.ctypes.data_as(_INT64_P))
        return out
