"""Batch loader: seeded shuffling, threaded prefetch, numpy collation, or a
corpus resident on the consumer's device.

A copy of ``hyperpocket_tpu/data/loader.py`` (numpy and threads).
``process_shard=(index, count)`` makes each process load only its rows of
every global batch; the data-parallel Trainer passes its data-axis
coordinate.

The replacement for the reference's torch DataLoader usage
(core/main.py:91-93): per-epoch deterministic shuffling keyed on
(seed, epoch), drop_last semantics, a thread pool for parallel item loading
(PLY/h5 reads release the GIL in numpy/h5py), and double-buffered batch
prefetch so host I/O overlaps device compute.

The resident route. A consumer that passes ``device`` (the Trainer passes
its own) gets batches as tensors on that device when the dataset's items
cannot change: on its first epoch the loader reads every item once (the
same ``__getitem__``, the same item threads), stacks each ndarray column
(n, ...) in fp32, as ``collate`` casts it, uploads it in one copy, and keeps
the other columns (labels, Completion3D's ``missing = 0``) as per-item
lists on the host. Every epoch then uploads its index batches (the same
``_batch_indices``) as one int64 tensor and gathers each column with one
index op on the device: the uniform prefix straight into one (S, B, ...)
stack whose rows are the batches, the ragged tail as a shorter gather. The
batches are bit-equal to the host route's, uploaded. The route engages only
when all of these hold; otherwise the loader logs once why and runs the
host route:

* ``device`` is given;
* the dataset's ``items_fixed`` is true (``__getitem__`` a pure function
  of the index over cached arrays; a dataset without it counts as false);
* each ndarray column has one shape over all items;
* on a CUDA device, the corpus takes at most a quarter of the card's free
  memory when it is built.

Under a profiler (``utils/profiling.py``) the resident route counts
``loader.resident`` (an epoch served from the corpus; the host seconds of
the build on the epoch that builds it), ``loader.items`` (items gathered;
the host seconds of the index upload and the gathers) and
``loader.collate`` (batches; the seconds of assembling them), and
``loader.wait`` spans the consumer's receipt of each batch.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np
import torch

from hyperpocket_tpu_torch.utils import profiling

_log = logging.getLogger(__name__)

# a resident corpus takes at most this share of the card's free memory
_RESIDENT_SHARE = 0.25


def collate(items: Sequence[tuple]) -> tuple:
    """Stack a list of (existing, missing, gt, label) into batch arrays.

    ndarray fields are stacked; scalar placeholders (the reference's
    ``missing = 0`` for Completion3D) become an int zeros vector; string
    labels stay a list.
    """
    return tuple(_collate_column(col) for col in zip(*items))


def _collate_column(col: Sequence):
    first = col[0]
    if isinstance(first, np.ndarray):
        return np.stack(col).astype(np.float32, copy=False)
    if isinstance(first, (int, np.integer, float, np.floating)):
        return np.asarray(col)
    return list(col)


def _free_bytes(device: torch.device) -> int | None:
    """The device's free memory now; None where no budget applies (the CPU)."""
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[0]


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
        process_shard: tuple[int, int] = (0, 1),
        device: str | torch.device | None = None,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(0, int(num_workers))
        self.prefetch = max(1, int(prefetch))
        self.device = None if device is None else torch.device(device)
        # the resident corpus's columns once built, False once the host route
        # was chosen, None before the first epoch on a device
        self._corpus: list | bool | None = None if self.device is not None else False
        # each process loads its slice of every global batch; shuffling stays
        # keyed on (seed, epoch) only, so all processes agree on the order
        self.process_index, self.process_count = process_shard
        if self.process_count > 1:
            if self.batch_size % self.process_count:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by process_count {self.process_count}"
                )
            if not drop_last:
                # a short final batch would split unevenly or leave some
                # processes a step short, and the next collective would hang
                raise ValueError("multi-host sharded loading requires drop_last=True")

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    @property
    def resident(self) -> bool:
        """Whether the batches come from a corpus resident on ``device``."""
        return isinstance(self._corpus, list)

    def _batch_indices(self, epoch: int) -> list[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        batches = [order[i : i + self.batch_size] for i in range(0, n, self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.process_count > 1:
            per_host = self.batch_size // self.process_count
            start = self.process_index * per_host
            batches = [b[start : start + per_host] for b in batches]
            batches = [b for b in batches if len(b)]
        return batches

    def _load(self, idx: np.ndarray, fetch, counted: bool) -> tuple:
        """One collated batch, its items fetched by ``fetch``; the seconds
        counted as ``loader.items`` and ``loader.collate`` when ``counted``."""
        t0 = time.perf_counter()
        items = list(fetch(self.dataset.__getitem__, [int(i) for i in idx]))
        t1 = time.perf_counter()
        batch = collate(items)
        if counted:
            profiling.count("loader.items", len(items), t1 - t0)
            profiling.count("loader.collate", 1, time.perf_counter() - t1)
        return batch

    def epoch(self, epoch: int = 0) -> Iterator[tuple]:
        """Iterate collated batches for one epoch (deterministic per epoch):
        numpy arrays, or on the resident route tensors on ``device`` (the
        corpus built on the first such epoch; the module docstring).

        While a profiler records on the consumer's thread when the epoch
        starts, the loading is counted (``loader.items``, ``loader.collate``)
        and the consumer's waits on the queue are ``loader.wait`` spans."""
        batches = self._batch_indices(epoch)
        if not batches:
            return
        counted = profiling.recording()
        built = self._build() if self._corpus is None else None
        if self.resident:
            yield from self._gathered(batches, counted, built)
            return
        if self.num_workers == 0:
            for idx in batches:
                yield self._load(idx, map, counted)
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
                    if not put(self._load(idx, pool.map, counted)):
                        return
                put(None)
            except BaseException as exc:  # surface loader errors to the consumer
                put(exc)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                with profiling.span("loader.wait"):
                    item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)

    # ------------------------------------------------------------------
    def _host_route(self, why: str) -> None:
        _log.info("loader of %d items on %s: host route, %s", len(self.dataset), self.device, why)
        self._corpus = False

    def _build(self) -> float | None:
        """Decide the route on the first epoch on a device and, where the
        resident route engages, build the corpus: its host seconds, or None."""
        t0 = time.perf_counter()
        ds = self.dataset
        if not getattr(ds, "items_fixed", False):
            return self._host_route("the dataset's items are not fixed")
        first = ds[0]
        arrays = [isinstance(v, np.ndarray) for v in first]
        nbytes = len(ds) * sum(4 * v.size for v in first if isinstance(v, np.ndarray))
        free = _free_bytes(self.device)
        if free is not None and nbytes > _RESIDENT_SHARE * free:
            return self._host_route(
                f"the corpus ({nbytes / 2**20:.1f} MiB) exceeds {_RESIDENT_SHARE:.0%} of the "
                f"device's free {free / 2**20:.1f} MiB")
        if self.num_workers:
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                items = list(pool.map(ds.__getitem__, range(len(ds))))
        else:
            items = [ds[i] for i in range(len(ds))]
        cols = list(zip(*items))
        for c, is_array in enumerate(arrays):
            if is_array and any(not isinstance(v, np.ndarray) or v.shape != first[c].shape
                                for v in cols[c]):
                return self._host_route(f"column {c} has more than one shape")
        pinned = self.device.type == "cuda"
        corpus: list = []
        for c, is_array in enumerate(arrays):
            if not is_array:
                corpus.append(list(cols[c]))
                continue
            host = torch.empty((len(ds), *first[c].shape), dtype=torch.float32, pin_memory=pinned)
            rows = host.numpy()
            for row, v in zip(rows, cols[c]):
                row[...] = v  # the cast collate's astype makes
            corpus.append(host.to(self.device, non_blocking=pinned))
        self._corpus = corpus
        seconds = time.perf_counter() - t0
        _log.info("loader of %d items on %s: resident route, %.1f MiB built in %.3f s",
                  len(ds), self.device, nbytes / 2**20, seconds)
        return seconds

    def _gathered(self, batches: list[np.ndarray], counted: bool,
                  built: float | None) -> Iterator[tuple]:
        """The epoch's batches gathered from the resident corpus; the
        gathers are launched on the receipt of the first."""
        size = len(batches[0])
        n_prefix = len(batches) - (len(batches[-1]) != size)
        for k, idx in enumerate(batches):
            with profiling.span("loader.wait"):
                t0 = time.perf_counter()
                if k == 0:
                    gathered = self._gather(batches, n_prefix, size)
                    if counted:
                        profiling.count("loader.resident", 1, built or 0.0)
                        profiling.count("loader.items", sum(map(len, batches)),
                                        time.perf_counter() - t0)
                        t0 = time.perf_counter()
                batch = tuple(
                    _collate_column([col[i] for i in idx]) if g is None
                    else g[0][k] if k < n_prefix else g[1]
                    for col, g in zip(self._corpus, gathered))
                if counted:
                    profiling.count("loader.collate", 1, time.perf_counter() - t0)
            yield batch

    def _gather(self, batches: list[np.ndarray], n_prefix: int, size: int) -> list:
        """Each tensor column's (prefix stack (S, B, ...), tail or None), None
        for a host column: the batches' indices go up as one int64 tensor,
        and each column takes one index op for the prefix and one for the
        tail."""
        flat = torch.from_numpy(np.concatenate(batches).astype(np.int64, copy=False))
        if self.device.type == "cuda":
            flat = flat.pin_memory()
        flat = flat.to(self.device, non_blocking=True)
        prefix, tail = flat[:n_prefix * size], flat[n_prefix * size:]
        out: list = []
        for col in self._corpus:
            if not torch.is_tensor(col):
                out.append(None)
                continue
            stack = col.new_empty((n_prefix, size, *col.shape[1:]))
            torch.index_select(col, 0, prefix, out=stack.view(-1, *col.shape[1:]))
            out.append((stack, torch.index_select(col, 0, tail) if len(tail) else None))
        return out

    def __iter__(self) -> Iterator[tuple]:
        return self.epoch(0)
