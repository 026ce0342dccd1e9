"""Profiling and tracing hooks.

Counterpart of ``hyperpocket_tpu/utils/profiling.py``:

* ``trace(dir)``: context manager around ``torch.profiler`` that writes a
  Chrome trace (``trace.json``, viewable in Perfetto or TensorBoard) of
  whatever runs inside, the card's kernels included when CUDA is up.
* ``StepTimer``: cheap rolling step-time/throughput stats for training logs.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque


@contextlib.contextmanager
def trace(log_dir: str):
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling mean step time + items/sec over the last ``window`` steps."""

    def __init__(self, window: int = 50):
        self._durations: deque[float] = deque(maxlen=window)
        self._items: deque[int] = deque(maxlen=window)
        self._start: float | None = None

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self, items: int = 1) -> float:
        if self._start is None:
            raise RuntimeError("StepTimer.stop() without start()")
        dt = time.perf_counter() - self._start
        self._start = None
        self._durations.append(dt)
        self._items.append(items)
        return dt

    @property
    def mean_step_seconds(self) -> float:
        return sum(self._durations) / len(self._durations) if self._durations else 0.0

    @property
    def items_per_second(self) -> float:
        total = sum(self._durations)
        return sum(self._items) / total if total else 0.0
