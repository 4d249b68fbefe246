"""Prefetching batch loader: host gather -> pad to fixed shape -> device
(port of ``multimodal_clinical_tpu/data/loader.py``).

The loader asks the dataset for a whole batch at once
(``dataset.gather(indices)``), pads the tail batch to the static batch
size with a ``valid`` mask, attaches the global sample ``idx`` stream, and
overlaps the next batch's host work and host-to-device copy with the
current step through a background producer thread.

``workers > 1`` splits each batch's gather across a thread pool; every
dataset's ``gather`` is stateless, so the batches are the same under any
split.  Host batches are CPU tensors with the numpy gather's dtypes,
except that float32 ``x*`` keys other than ``*_waveform`` are cast to
``transfer_dtype`` (bf16 when the model computes in bf16: half the bytes
to copy, and the towers cast to it first anyway; the raw waveform stays
f32 for the log-STFT kernel).  The cast rounds to nearest even, as the JAX
loader's ``ml_dtypes`` cast does.

On a CUDA device the producer thread sets the device, pins each host
batch, and copies it with ``non_blocking=True`` on a side stream, then
records an event.  The consumer's stream waits on that event before it
uses the batch, and every device tensor is ``record_stream``-ed on the
consumer's stream, so the caching allocator does not hand its memory back
while the step still reads it.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.hostmem import warm_heap

Batch = Dict[str, torch.Tensor]


def _pad_batch(batch: Dict[str, np.ndarray], idx: np.ndarray,
               batch_size: int, valid_n: int) -> Dict[str, np.ndarray]:
    out = {}
    for key, arr in batch.items():
        arr = np.asarray(arr)
        if valid_n < batch_size:
            # repeat the last real row: keeps padded rows in-distribution
            # (they still flow through train-mode BN) while 'valid' masks
            # them out of every loss and metric
            pad = np.repeat(arr[-1:], batch_size - valid_n, axis=0)
            arr = np.concatenate([arr, pad], axis=0)
        out[key] = arr
    valid = np.zeros(batch_size, np.float32)
    valid[:valid_n] = 1.0
    out["idx"] = idx.astype(np.int32)
    out["valid"] = valid
    return out


class Loader:
    """Iterates fixed-shape batch dicts of tensors on ``device``."""

    def __init__(self, dataset, batch_size: int, sampler, prefetch: int = 2,
                 workers: int = 1,
                 transfer_dtype: Optional[torch.dtype] = None,
                 device="cuda"):
        warm_heap()  # batch assembly is first-touch-bound otherwise
        self._copy = DeviceCopy(device)
        self.device = self._copy.device
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.sampler = sampler
        self.prefetch = max(1, int(prefetch))
        self.workers = max(1, int(workers))
        self.transfer_dtype = transfer_dtype
        self._epoch = 0
        self._skip_n = 0
        self._pool: Optional[ThreadPoolExecutor] = None
        if self.workers > 1:
            self._pool = ThreadPoolExecutor(max_workers=self.workers,
                                            thread_name_prefix="loader")

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)
        # disk datasets derive per-(seed, epoch, index) augmentation rng
        # (data/core.sample_rng): forward the epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self._epoch)

    def skip(self, n_batches: int) -> None:
        """Drop the first ``n_batches`` of the NEXT iteration at the index
        level (mid-epoch resume, engine/trainer.py): skipped batches are
        never gathered or copied.  One-shot: consumed by the next
        ``__iter__``."""
        self._skip_n = max(0, int(n_batches))

    def __len__(self) -> int:
        return -(-len(self.sampler) // self.batch_size)

    # -- host side -----------------------------------------------------
    def _gather(self, chunk: np.ndarray) -> Dict[str, np.ndarray]:
        if self._pool is None or len(chunk) < 2 * self.workers:
            return self.dataset.gather(chunk)
        parts = np.array_split(chunk, self.workers)
        futs = [self._pool.submit(self.dataset.gather, p) for p in parts
                if len(p)]
        results = [f.result() for f in futs]
        return {k: np.concatenate([r[k] for r in results], axis=0)
                for k in results[0]}

    def _host_tensor(self, key: str, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if (self.transfer_dtype is None or t.dtype != torch.float32
                or not key.startswith("x") or key.endswith("_waveform")):
            return t
        return t.to(self.transfer_dtype)

    def _host_batches(self) -> Iterator[Batch]:
        idxs = np.asarray(self.sampler.indices(self._epoch))
        bs = self.batch_size
        skip, self._skip_n = self._skip_n, 0
        for start in range(skip * bs, len(idxs), bs):
            chunk = idxs[start:start + bs]
            valid_n = len(chunk)
            idx_padded = chunk if valid_n == bs else np.concatenate(
                [chunk, np.repeat(chunk[-1:], bs - valid_n)])
            # gather only the real rows; _pad_batch repeats the last row
            batch = _pad_batch(self._gather(chunk), idx_padded, bs, valid_n)
            yield {k: self._host_tensor(k, v) for k, v in batch.items()}

    def __iter__(self):
        return prefetched_iter(self._host_batches(), self._copy.put,
                               self.prefetch, take=self._copy.take)


class DeviceCopy:
    """Host batches to ``device``: ``put`` on the producer's thread, ``take``
    on the consumer's (``prefetched_iter``).  On a CUDA device the copy
    runs on a side stream and the consumer's stream waits for it."""

    def __init__(self, device="cuda"):
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            # the producer thread sets the device by its index
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self._stream = (torch.cuda.Stream(device)
                        if device.type == "cuda" else None)

    def put(self, batch: Batch):
        """Producer side: (device batch, copy-done event or None)."""
        if self._stream is None:
            return {k: v.to(self.device) for k, v in batch.items()}, None
        torch.cuda.set_device(self.device)
        with torch.cuda.stream(self._stream):
            out = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def take(self, item) -> Batch:
        """Consumer side: order the consumer's stream after the copy."""
        batch, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in batch.values():
                t.record_stream(stream)
        return batch


def prefetched_iter(host_batches, put: Callable, prefetch: int,
                    take: Optional[Callable] = None):
    """Producer-thread prefetch: overlaps ``put(next_host_batch)`` (host
    assembly and the copy to the device) with the consumer's step; ``take``
    runs on the consumer's thread for each item it receives.
    Abandonment-safe: breaking out of or collecting the iterator stops the
    producer, so it neither goes on copying batches nor pins device memory
    in the queue."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, int(prefetch)))
    stop = threading.Event()
    _END, _ERR = object(), object()

    def offer(item) -> bool:
        # bounded put: gives up when the consumer abandoned the iterator,
        # so the producer cannot block forever on a full queue
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for host_batch in host_batches:
                if stop.is_set():
                    return
                if not offer(put(host_batch)):
                    return
        except BaseException as exc:  # re-raised on the consumer side
            offer((_ERR, exc))
        else:
            offer(_END)

    thread = threading.Thread(target=produce, daemon=True,
                              name="loader-producer")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if (isinstance(item, tuple) and len(item) == 2
                    and item[0] is _ERR):
                raise item[1]
            yield take(item) if take is not None else item
    finally:
        # runs on exhaustion AND on abandonment (break / exception /
        # generator collection)
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        thread.join(timeout=10.0)
