"""Host allocator tuning for the loader's batches (port of
``multimodal_clinical_tpu/utils/hostmem.py``).

glibc serves every allocation above its dynamic threshold with a fresh
``mmap`` and returns it with ``munmap`` on free, so each batch's large
arrays (the gather's parts, their concatenation) are new pages that fault
in and are zeroed on first touch, every batch.  ``warm_heap()`` turns off
glibc's mmap path (``M_MMAP_MAX=0``) and heap trimming
(``M_TRIM_THRESHOLD=-1``), so large buffers come from the brk arena, which
stays warm across free/alloc cycles.  It changes the whole process's
allocator, once; the ``Loader`` calls it.  No-op where libc's ``mallopt``
is not there.
"""

from __future__ import annotations

import ctypes

_done = False


def warm_heap() -> bool:
    global _done
    if _done:
        return True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
    except OSError:
        return False
    M_TRIM_THRESHOLD, M_MMAP_MAX = -1, -4
    ok = bool(libc.mallopt(M_MMAP_MAX, 0))
    ok = bool(libc.mallopt(M_TRIM_THRESHOLD, -1)) and ok
    _done = ok
    return ok
