"""The device trace of a run's window: ``torch.profiler`` (CPU + CUDA) over
the window, exported as a Chrome trace and reduced to what the per-layer
metrics read.

``Summary`` holds the window's length (the harness's ``WINDOW`` span), the
seconds in which some operation ran on the card (kernels, copies and
fills, their union), each kernel's count and seconds by name, the copies'
by direction, and the breakdown the result line carries: the device
operations that took most time, and the idle gaps named by the innermost
host operation that covered each.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import heapq
import json
import os
import tempfile

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
GAPS_NAMED = 20000  # the longest idle gaps named one by one; the rest are summed apart
TOP = 10


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: dict  # name -> [count, seconds]
    copies: dict  # "HtoD" / "DtoH" / "DtoD" / ... -> [count, seconds]
    device_ops: list  # [[name, seconds], ...], the TOP longest by name
    idle_gaps: list  # [[host operation, seconds], ...], the TOP largest sums

    def kernel_seconds(self, *fragments: str) -> tuple[int, float]:
        """(launches, seconds) of the kernels whose name holds any fragment."""
        n = s = 0
        for name, (count, sec) in self.kernels.items():
            if any(f in name for f in fragments):
                n, s = n + count, s + sec
        return n, s


@contextlib.contextmanager
def profiled(enabled: bool):
    """``torch.profiler`` over the block when ``enabled``; yields a holder
    whose ``summary`` is set once the block has closed."""
    holder = type("Traced", (), {"summary": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield holder
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    holder.summary = summarize(events)


def spanned(name: str, fn):
    """``fn`` inside a profiler span ``name``: the harness's own spans around
    its calls into the program's layers, which name the idle gaps."""
    import torch

    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return call


def _copy_kind(name: str) -> str:
    for kind in ("HtoD", "DtoH", "DtoD", "HtoH", "PtoP"):
        if kind in name:
            return kind
    return name


def summarize(events: list) -> Summary:
    """Reduce Chrome-trace events to a ``Summary`` of the ``WINDOW`` span."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} '{WINDOW}' spans, not one")
    win = windows[0]
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])

    device, kernels, copies = [], {}, {}
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        t0, t1 = max(t0, w0), min(t1, w1)
        if t1 <= t0:
            continue
        device.append((t0, t1))
        sec = (t1 - t0) * 1e-6
        table, key = ((kernels, e["name"]) if e["cat"] == "kernel"
                      else (copies, _copy_kind(e["name"])))
        entry = table.setdefault(key, [0, 0.0])
        entry[0] += 1
        entry[1] += sec

    device.sort()
    busy, gaps, cursor = 0.0, [], w0
    for t0, t1 in device:
        if t0 > cursor:
            gaps.append((cursor, t0))
        if t1 > cursor:
            busy += t1 - max(t0, cursor)
            cursor = t1
    if w1 > cursor:
        gaps.append((cursor, w1))

    host = [e for e in xs if e.get("cat") in HOST_CATS and e.get("tid") == win.get("tid")
            and e.get("pid") == win.get("pid")]
    longest = heapq.nlargest(GAPS_NAMED, gaps, key=lambda g: g[1] - g[0])
    named = _name_gaps(longest, host)
    rest = sum(b - a for a, b in gaps) - sum(b - a for a, b in longest)
    if rest > 0:
        named["(shorter gaps)"] = rest
    ops = {**{k: v[1] for k, v in kernels.items()},
           **{f"Memcpy {k}": v[1] for k, v in copies.items()}}
    return Summary(
        window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6, kernels=kernels, copies=copies,
        device_ops=[[k, v] for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=[[k, v * 1e-6] for k, v in
                   sorted(named.items(), key=lambda kv: -kv[1])[:TOP]])


def _name_gaps(gaps: list, host: list) -> dict:
    """Each gap's length summed under the innermost host event that covers
    its midpoint (events of one thread nest, so a sweep with a stack of the
    open events finds it)."""
    spans = sorted(((float(e["ts"]), -float(e["dur"]), e["name"]) for e in host))
    starts = [s[0] for s in spans]
    queries = sorted(((a + b) / 2, b - a) for a, b in gaps)
    out: dict = {}
    stack: list = []
    i = 0
    for mid, length in queries:
        j = bisect.bisect_right(starts, mid, lo=i)
        for ts, neg_dur, name in spans[i:j]:
            while stack and stack[-1][0] < ts:
                stack.pop()
            stack.append((ts - neg_dur, name))
        i = j
        while stack and stack[-1][0] < mid:
            stack.pop()
        name = stack[-1][1] if stack else "(no host operation)"
        out[name] = out.get(name, 0.0) + length
    return out
