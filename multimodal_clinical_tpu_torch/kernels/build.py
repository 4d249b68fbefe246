"""Builds the port's CUDA sources (``csrc/*.cu``) with nvcc for ``sm_90a``.

Each source becomes a shared library with a plain C interface, loaded with
``ctypes``: no PyTorch headers, so a build takes seconds.  Libraries go to
``build/torch_kernels/`` at the repository root (listed in ``.gitignore``),
named by a digest of the source and the flags, so a changed source is
rebuilt and a stale library is never loaded.  Nothing is built at import
time; the first ``load`` builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("log_spectrogram", "bn_sums", "maxpool", "identity_copy",
           "bn_stats", "conv3x3")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found (PATH or {cuda_home}/bin)")
    return nvcc


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every source in ``names`` that has no library yet, one nvcc
    process per source, all started together.  Returns seconds per source
    built; nvcc's output (ptxas register and shared-memory counts) goes
    beside each library as ``.log``.  Raises with nvcc's output if one
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        dst = library_path(name)
        if dst.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, dst)
    seconds, failed = {}, []
    for name, (proc, tmp, dst) in jobs.items():
        output = proc.communicate()[0]
        seconds[name] = time.perf_counter() - t0
        dst.with_suffix(".log").write_text(output)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {name}.cu:\n{output}")
        else:
            os.replace(tmp, dst)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
