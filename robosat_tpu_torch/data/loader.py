"""Host-side batching with threaded prefetch.

Counterpart of robosat_tpu/data/loader.py: a thread pool in place of torch
DataLoader worker processes (image decode releases the GIL inside the
native codec, PIL and zlib, so threads overlap decode with device compute
without fork overhead). Batches are padded to a fixed shape; `valid` marks
the real rows of the final batch.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class Batch:
    __slots__ = ("arrays", "meta", "valid")

    def __init__(self, arrays, meta, valid):
        self.arrays = arrays  # tuple of stacked numpy arrays, padded to batch size
        self.meta = meta  # list (len == valid) of per-sample metadata (e.g. tiles)
        self.valid = valid  # number of real samples in this batch


def _pad_stack(items, batch_size):
    """Stack samples, repeating the last to pad up to `batch_size`."""
    arr = np.stack(items)
    if len(items) < batch_size:
        pad = np.repeat(arr[-1:], batch_size - len(items), axis=0)
        arr = np.concatenate([arr, pad], axis=0)
    return arr


def _rank_rows(idx, batch_size, mesh):
    """(dataset indices, real rows) of this rank's rows of one global batch
    `idx` padded to `batch_size` by repeating its last index."""
    padded = np.concatenate([idx, np.repeat(idx[-1:], batch_size - len(idx))])
    rows = mesh.rows(batch_size)
    return padded[rows], int(np.clip(len(idx) - rows.start, 0, rows.stop - rows.start))


def batches(dataset, batch_size, shuffle=False, drop_last=False, workers=4, seed=0, prefetch=2, mesh=None):
    """Yield Batch objects over `dataset` with background prefetch.

    `dataset[i]` must return a tuple whose leading elements are numpy arrays
    (stacked/padded) and whose last element is per-sample metadata.

    With a `mesh` (parallel/mesh.py) `batch_size` is the global batch, a
    multiple of the world size: every rank walks the same order (`seed`)
    and loads only its rows of each global batch, the padding of a short
    last batch included (its `valid` counts the rank's real rows, 0 where
    the rank's rows are all padding).
    """
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)

    chunks = []
    for start in range(0, len(order), batch_size):
        idx = order[start : start + batch_size]
        if drop_last and len(idx) < batch_size:
            continue
        chunks.append(idx)
    if mesh is not None:
        chunks = [_rank_rows(idx, batch_size, mesh) for idx in chunks]
        batch_size //= mesh.size

    if not chunks:
        return

    out_q = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def load_chunk(chunk):
        idx, valid = chunk if mesh is not None else (chunk, len(chunk))
        samples = [dataset[int(i)] for i in idx]
        n_arrays = len(samples[0]) - 1
        arrays = tuple(_pad_stack([s[k] for s in samples], batch_size) for k in range(n_arrays))
        meta = [s[-1] for s in samples[:valid]]
        return Batch(arrays, meta, valid)

    def producer():
        try:
            with ThreadPoolExecutor(max_workers=max(workers, 1)) as pool:
                for batch in pool.map(load_chunk, chunks):
                    if stop.is_set():
                        return
                    out_q.put(batch)
        except BaseException as exc:  # surface loader errors to the consumer
            out_q.put(exc)
        finally:
            out_q.put(None)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()

    try:
        while True:
            item = out_q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # Drain so the producer can finish putting and exit.
        while thread.is_alive():
            try:
                out_q.get_nowait()
            except queue.Empty:
                thread.join(timeout=0.1)
