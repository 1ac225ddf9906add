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


def batches(dataset, batch_size, shuffle=False, drop_last=False, workers=4, seed=0, prefetch=2):
    """Yield Batch objects over `dataset` with background prefetch.

    `dataset[i]` must return a tuple whose leading elements are numpy arrays
    (stacked/padded) and whose last element is per-sample metadata.
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

    if not chunks:
        return

    out_q = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def load_chunk(idx):
        samples = [dataset[int(i)] for i in idx]
        n_arrays = len(samples[0]) - 1
        arrays = tuple(_pad_stack([s[k] for s in samples], batch_size) for k in range(n_arrays))
        meta = [s[-1] for s in samples]
        return Batch(arrays, meta, len(samples))

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
