"""Batching, background loading and the copy to the device (counterpart of
``pci_tpu/data/pipeline.py``: ``collate`` and ``Loader`` are copies; the
JAX package's ``device_put_batches`` is :func:`to_device`).

A thread pool builds the next batch while the device runs this one, and
the copy to a CUDA device goes through pinned host memory without
blocking the host.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch


def collate(samples: list[dict]) -> dict:
    """Stack a list of sample dicts into one batch dict.  Lists of arrays
    (frame lists) stay lists, each element batched."""
    out = {}
    first = samples[0]
    for k, v in first.items():
        if isinstance(v, list):
            out[k] = [
                np.stack([s[k][i] for s in samples]) for i in range(len(v))
            ]
        else:
            out[k] = np.stack([s[k] for s in samples])
    return out


class Loader:
    """Iterable over shuffled, collated batches with worker threads."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 8,
        seed: int = 0,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        nb = len(self)
        for b in range(nb):
            yield order[b * self.batch_size : (b + 1) * self.batch_size]

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def produce():
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                for idxs in self._batch_indices():
                    samples = list(pool.map(self.dataset.__getitem__, idxs))
                    q.put(collate(samples))
            q.put(sentinel)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item


def to_device(batch: dict, device) -> dict:
    """A collated numpy batch -> the same dict of tensors on ``device``
    (frame lists stay lists).  To CUDA through pinned host memory,
    asynchronously on the current stream."""
    device = torch.device(device)

    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return {k: [put(x) for x in v] if isinstance(v, list) else put(v)
            for k, v in batch.items()}
