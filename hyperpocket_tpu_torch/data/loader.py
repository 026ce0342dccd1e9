"""Host-side batch loader: seeded shuffling, threaded prefetch, numpy collation.

A copy of ``hyperpocket_tpu/data/loader.py`` (numpy and threads), without
its multi-host sharding (``process_shard``), which comes with the
parallelism slice.

The replacement for the reference's torch DataLoader usage
(core/main.py:91-93): per-epoch deterministic shuffling keyed on
(seed, epoch), drop_last semantics, a thread pool for parallel item loading
(PLY/h5 reads release the GIL in numpy/h5py), and double-buffered batch
prefetch so host I/O overlaps device compute.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np


def collate(items: Sequence[tuple]) -> tuple:
    """Stack a list of (existing, missing, gt, label) into batch arrays.

    ndarray fields are stacked; scalar placeholders (the reference's
    ``missing = 0`` for Completion3D) become an int zeros vector; string
    labels stay a list.
    """
    cols = list(zip(*items))
    out = []
    for col in cols:
        first = col[0]
        if isinstance(first, np.ndarray):
            out.append(np.stack(col).astype(np.float32, copy=False))
        elif isinstance(first, (int, np.integer, float, np.floating)):
            out.append(np.asarray(col))
        else:
            out.append(list(col))
    return tuple(out)


class BatchLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        num_workers: int = 8,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(0, int(num_workers))
        self.prefetch = max(1, int(prefetch))

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self, epoch: int) -> list[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        batches = [order[i : i + self.batch_size] for i in range(0, n, self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def epoch(self, epoch: int = 0) -> Iterator[tuple]:
        """Iterate collated batches for one epoch (deterministic per epoch)."""
        batches = self._batch_indices(epoch)
        if not batches:
            return
        if self.num_workers == 0:
            for idx in batches:
                yield collate([self.dataset[int(i)] for i in idx])
            return

        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that gives up when the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for idx in batches:
                    if stop.is_set():
                        return
                    items = list(pool.map(self.dataset.__getitem__, [int(i) for i in idx]))
                    if not put(collate(items)):
                        return
                put(None)
            except BaseException as exc:  # surface loader errors to the consumer
                put(exc)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)

    def __iter__(self) -> Iterator[tuple]:
        return self.epoch(0)
