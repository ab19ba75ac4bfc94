"""Host-side prefetching: ``prefetch_iter`` for the streaming-inference
loop, ``PrefetchLoader`` for training.

The reference uses torch DataLoader worker processes and an optional
background-thread prefetcher (prefetch_dataloader.py:11-41, data/__init__.py
:61-130). Here, as in the JAX package's ``data/loader.py``, a thread pool
decodes a batch's clips (image decoding releases the GIL) and a bounded
queue keeps batches ready while the card steps.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np


def prefetch_iter(iterable, depth: int = 2):
    """Run ``iterable`` in a background thread, keeping up to ``depth`` items
    ready ahead of the consumer: frame decoding hides behind the device's
    work. An exception in the producer is raised again at the consumer's next
    pull; leaving the consuming loop early is safe (the producer is a daemon
    thread and gives up on a bounded put once the consumer has gone)."""
    if depth < 1:
        # Queue(maxsize=0) is UNBOUNDED: the producer would decode the whole
        # stream into host memory instead of reading nothing ahead
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end, err = object(), object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in iterable:
                if not put((None, item)):
                    return
        except BaseException as exc:  # raised again on the consumer's side
            put((err, exc))
            return
        put((end, None))

    threading.Thread(target=produce, daemon=True).start()
    try:
        while True:
            tag, item = q.get()
            if tag is end:
                break
            if tag is err:
                raise item
            yield item
    finally:
        stop.set()
        while not q.empty():
            q.get_nowait()


class PrefetchLoader:
    """Batches of ``dataset[i]`` for the indices of ``sampler``, in its
    order: ``num_workers`` threads load a batch's items, up to ``prefetch``
    batches wait ready in a queue. A batch is ``{"lq": (B, T, H, W, C),
    "gt": ..., "key": [the items' keys]}``; with ``drop_last`` a last
    incomplete batch is dropped."""

    def __init__(self, dataset, sampler, batch_size: int, *,
                 num_workers: int = 2, prefetch: int = 2,
                 drop_last: bool = True):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _collate(self, items):
        return {
            "lq": np.stack([it["lq"] for it in items]),
            "gt": np.stack([it["gt"] for it in items]),
            "key": [it["key"] for it in items],
        }

    def _batches(self, indices):
        with ThreadPoolExecutor(self.num_workers) as pool:
            batch_idx = []
            for i in indices:
                batch_idx.append(i)
                if len(batch_idx) == self.batch_size:
                    yield self._collate(list(pool.map(self.dataset.__getitem__,
                                                      batch_idx)))
                    batch_idx = []
            if batch_idx and not self.drop_last:
                yield self._collate(list(pool.map(self.dataset.__getitem__,
                                                  batch_idx)))

    def __iter__(self) -> Iterator[dict]:
        # the sampler's order is fixed here, after its set_epoch
        return prefetch_iter(self._batches(iter(self.sampler)),
                             depth=self.prefetch)
