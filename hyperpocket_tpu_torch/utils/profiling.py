"""Profiling and tracing: a Chrome trace, and the program's own spans in it.

Counterpart of ``hyperpocket_tpu/utils/profiling.py``:

* ``trace(dir)``: context manager around ``torch.profiler`` that writes a
  Chrome trace (``trace.json``, viewable in Perfetto or TensorBoard) of
  whatever runs inside, the card's kernels included when CUDA is up.
* ``span(name, args=None)``: a context manager around one part of the
  program's work. While a profiler records on the calling thread (``trace``,
  the Trainer's ``training.profile``, any ``torch.profiler.profile``), it is
  a profiler range, so it sits in the Chrome trace beside the card's
  kernels, copies and runtime calls on the profiler's clock (``args``, such
  as the epoch, among its inputs where the profiler records shapes), and
  its host seconds and a count of one are added to ``totals()`` under
  ``name``. Otherwise it is one shared object that does nothing: no
  allocation and no dispatcher call. The range is torch's
  ``_RecordFunctionFast``: ``record_function`` makes a dispatcher call
  whether or not anything records, and under a profiler costs several
  times as much a span, which the traced serving windows felt.
* ``count(name, value=1, seconds=0.0)``: adds to the same totals, for work on
  threads the profiler does not record (its state is thread-local): the
  caller reads ``recording()`` on a recorded thread and hands it on.
* ``tally(name, value=1)``: a counter of the step's routes, where the
  step's Python runs: added to the totals while a profiler records, and to
  the innermost open ``collected()`` whether or not one records. A CUDA
  graph's capture runs that Python once and its replays never, so
  ``train/epoch_scan.py`` collects what its capture tallied and, at each
  later call that replays the kept graph, adds it again with
  ``recount(counts)``, again only while a profiler records.
* ``totals()`` (``{name: (count, seconds)}``, a copy) and ``reset()``.

The spans, from the entry points down (``PERF.md`` §3 names the metric that
reads each):

* serving (``serving.py``): ``serving.completion`` a call, inside it
  ``serving.upload`` (the host arrays to the device), then from
  ``utils/cuda_graph.py::GraphCache`` ``serving.stage`` (the copies into
  the graph's static buffers), ``serving.replay`` (the seed and the
  replay; the eager forward off the card), ``serving.clone`` (the output
  out of the graph's pool), and ``serving.capture`` on a signature's first
  call;
* Trainer (``train/trainer.py``): ``trainer.train_epoch`` and
  ``trainer.val_epoch`` (args: the epoch), inside them ``trainer.collect``
  (a scanned epoch from the loader, its prefix stacked on the device, and
  a generator a batch), ``trainer.tail_step`` (a batch through the step
  function: a scanned epoch's ragged tail, every batch of a stepped one)
  and ``trainer.fetch`` (a result to the host, where the host waits for
  the card);
* loader (``data/loader.py``): ``loader.wait``, the consumer blocked on the
  prefetch queue; the producer thread counts ``loader.items`` (seconds in
  the items' ``__getitem__``, count = items) and ``loader.collate`` (count
  = batches); ``loader.upload`` is the host route's scanned prefix going up
  in one copy, inside ``trainer.collect``. On the resident route (a cached
  corpus kept on the device) ``loader.wait`` is the consumer's receipt of a
  batch or of a scanned epoch's whole prefix, ``loader.items`` the items
  gathered (seconds: the index upload and the gathers), ``loader.collate``
  the batches assembled, and ``loader.resident`` counts the epochs served
  from the corpus (seconds: its build, on the epoch that builds it);
* epoch graphs (``train/epoch_scan.py``): ``scan.rehearse``,
  ``scan.capture``, and a step's ``scan.fill`` (its batch and draws into the
  static buffers) and ``scan.replay``; the counter ``scan.kept`` counts the
  calls that replayed a graph kept from an earlier call;
* counters of the step's routes (``tally``): in a scanned epoch once a
  call, at the step's capture or, where the call replays a kept graph, from
  what that capture collected, so a traced epoch records the routes its
  graph holds; in eager steps once a step. ``encoder.trunk_route.<route>``
  (``models/encoder.py::trunk_grad_route``: ``k8``, ``sparse`` or
  ``chain``) once an encoder's training trunk, and ``adam_lowp.values``
  (``ops/adam_lowp.py``) the values an ``AdamLowp`` update launches over.
  They reach the totals only while a profiler records. The Trainer tallies
  ``trainer.compute_dtype.<dtype>`` once a train epoch, under the dtype
  the epoch runs in, outside any capture: an open ``collected()`` counts a
  whole run's epochs, profiled or not.

Reading a trace: the card is idle wherever no kernel, copy or fill runs;
the innermost span around such a gap on the host's thread names what the
host was doing meanwhile. A gap under ``loader.wait`` is the Trainer
waiting for batches the producer has not yet made; under
``trainer.collect`` but outside ``loader.wait``, the Trainer's own work a
batch; under ``serving.upload``, pageable host-to-device copies.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch
from torch.autograd import _profiler_enabled as recording

__all__ = ["collected", "count", "recording", "recount", "reset", "span", "tally", "totals",
           "trace"]

_lock = threading.Lock()
_totals: dict[str, list] = {}  # name -> [count, seconds]
_open = threading.local()  # .counts: the innermost collected() of the thread


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class _Off:
    """The span while nothing records: one shared object, no work."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "function", "t0")

    def __init__(self, name: str, args):
        self.name = name
        self.function = torch._C._profiler._RecordFunctionFast(
            name, () if args is None else (args,))

    def __enter__(self):
        self.function.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        seconds = time.perf_counter() - self.t0
        self.function.__exit__(*exc)
        count(self.name, 1, seconds)
        return False


def span(name: str, args: int | None = None):
    """A profiler span ``name`` (with ``args``) counted into ``totals()``
    while a profiler records on this thread; otherwise the shared no-op."""
    if not recording():
        return _OFF
    return _Span(name, args)


def count(name: str, value: int = 1, seconds: float = 0.0) -> None:
    """Add ``value`` and ``seconds`` to the totals under ``name``."""
    with _lock:
        entry = _totals.setdefault(name, [0, 0.0])
        entry[0] += value
        entry[1] += seconds


def tally(name: str, value: int = 1) -> None:
    """Count ``value`` under ``name``: into the totals while a profiler
    records on this thread, and into the thread's innermost ``collected()``."""
    counts = getattr(_open, "counts", None)
    if counts is not None:
        counts[name] = counts.get(name, 0) + value
    if recording():
        count(name, value)


@contextlib.contextmanager
def collected():
    """The dict of what ``tally`` counts on this thread inside the block,
    whether or not a profiler records."""
    outer, counts = getattr(_open, "counts", None), {}
    _open.counts = counts
    try:
        yield counts
    finally:
        _open.counts = outer


def recount(counts: dict[str, int]) -> None:
    """Add ``counts`` (a ``collected()`` dict) to the totals while a
    profiler records on this thread; otherwise nothing."""
    if recording():
        for name, value in counts.items():
            count(name, value)


def totals() -> dict[str, tuple[int, float]]:
    """``{name: (count, seconds)}`` of every span and counter so far."""
    with _lock:
        return {k: (n, s) for k, (n, s) in _totals.items()}


def reset() -> None:
    with _lock:
        _totals.clear()
