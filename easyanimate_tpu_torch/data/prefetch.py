"""Host-side input pipeline: threaded sample loading and device prefetch.

Parity: easyanimate_tpu/data/prefetch.py (the reference trains through
torch DataLoader worker processes, train.py:1512-1514, and overlaps the
VAE encode with the DiT on extra CUDA streams, train.py:1639-1645):
  - DataLoader: a producer thread pulls batches of indices from the batch
    sampler, loads each batch's samples with `num_workers` threads, and
    queues the collated batches in order, `prefetch_batches` ahead. The
    producer advances the sampler as it runs, so the sampler's cursor is
    ahead of the batches taken by the queued ones (and any part-filled
    bucket); a checkpoint that saves it skips those batches on resume, as
    JAX's does. Closing the iterator stops and joins the producer.
  - default_collate: numpy arrays stacked, other values as lists.
  - device_prefetch: each batch's arrays copied into pinned host memory and
    sent to the device with a non-blocking copy, `size` batches ahead.
"""
import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device


def default_collate(items: Sequence[dict]) -> dict:
    """Stack same-key numpy arrays; pass through non-array values as lists."""
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        else:
            out[k] = vals
    return out


class DataLoader:
    """Minimal threaded loader: pulls indices from a sampler, loads samples
    with `num_workers` threads, yields collated batches in order."""

    def __init__(self, dataset, batch_sampler: Iterable[Sequence[int]],
                 num_workers: int = 4,
                 collate_fn: Callable = default_collate,
                 prefetch_batches: int = 2):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.num_workers = max(1, num_workers)
        self.collate_fn = collate_fn
        self.prefetch_batches = max(1, prefetch_batches)

    def __iter__(self) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(self.prefetch_batches)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in self.batch_sampler:
                        items = list(pool.map(self.dataset.__getitem__,
                                              batch_idx))
                        if not put(self.collate_fn(items)):
                            return
            except Exception as e:  # handed to the consumer, which raises it
                put(e)
                return
            put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            # closing the iterator stops the producer (it stops between
            # batches) and waits for it, so the sampler's cursor is still
            # once this returns
            stop.set()
            t.join()


def to_device(batch: dict, device=None) -> dict:
    """A batch's numpy arrays as tensors on `device` (the card by default):
    pinned host copies sent with non-blocking copies; other values as they
    are."""
    device = resolve_device(device)
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
        else:
            out[k] = v
    return out


def device_prefetch(it: Iterator[dict], size: int = 2,
                    transform: Optional[Callable] = None,
                    device=None) -> Iterator[dict]:
    """Keep `size` batches sent ahead of consumption: each copy is queued
    while the previous step runs."""
    buf = collections.deque()
    for b in it:
        buf.append(to_device(transform(b) if transform else b, device))
        if len(buf) > size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
