"""CUDA-graph capture and replay: what the scanned epochs and the serving calls share.

The port's counterpart of ``jax.jit``'s compiled programs. A function of
tensors on a card is captured once into a ``torch.cuda.CUDAGraph`` over
static buffers and replayed: the host issues one launch where an eager call
issues hundreds. Two users:

* ``train/epoch_scan.py::EpochScan`` captures a train or val step once
  for each signature (shapes, route switches, the optimizer's
  hyperparameters, the addresses of the parameters and of its state),
  keeps that graph across epochs and replays it a step (``capture``,
  ``warm_up``);
* ``serving.py`` captures its serving forward, the seed's ball draw
  included, once for each input signature and replays it at every later
  call (``GraphCache``), as ``jax.jit`` compiles once per shape.

* Warm-up: cuBLAS, NCCL and the kernels' own first launches (their build,
  their attributes) make state that a capture must not record. ``warm_up``
  runs the function once eagerly on the capture's stream first; its
  launches ran on the card and stay counted.
* Launch counts: a wrapper counts one launch when the capture records it
  (``ops.launch_counters``). ``capture`` takes those back, and
  ``Graph.replay`` adds them again at every replay, so each ``.launches``
  is the number of launches the card ran.
* Failure: the capture runs under ``torch.cuda.set_sync_debug_mode("error")``.
  An operation that syncs the host, or any other error of the capture,
  raises ``GraphCaptureError`` naming the line where it arose. Nothing
  falls back to eager calls.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from typing import Callable

import torch

from hyperpocket_tpu_torch.ops import launch_counters
from hyperpocket_tpu_torch.utils.profiling import span


class GraphCaptureError(RuntimeError):
    """A function could not be captured as a CUDA graph."""


def launch_counts() -> list[int]:
    return [getattr(owner, attr) for owner, attr in launch_counters()]


def where(exc: BaseException) -> str:
    """The innermost frame of ``exc`` outside torch: the line that failed."""
    frames = traceback.extract_tb(exc.__traceback__)
    own = [f for f in frames if "/torch/" not in f.filename.replace("\\", "/")]
    f = (own or frames)[-1]
    return f"{f.filename}:{f.lineno} ({f.line})"


def signature(*tensors: torch.Tensor, static: tuple = ()) -> tuple:
    """The key of a capture: each input's shape, dtype and device, then
    ``static`` (what the function fixes, such as its compute dtype)."""
    return (*((tuple(t.shape), t.dtype, t.device) for t in tensors), *static)


def warm_up(run: Callable, stream: torch.cuda.Stream, device: torch.device):
    """``run()`` once eagerly on ``stream``, after the current stream's work;
    the current stream waits for it. Returns what ``run`` returns."""
    current = torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = run()
    current.wait_stream(stream)
    return out


@dataclasses.dataclass
class Graph:
    """A captured graph and its static outputs.

    ``per_replay``: each launch counter's launches a replay (in the order of
    ``ops.launch_counters``); ``capture_ms``: host ms of the capture from an
    idle card, instantiation included; ``pool_bytes``: the memory the
    capture reserved for its private pool.
    """

    graph: torch.cuda.CUDAGraph
    out: object
    per_replay: list[int]
    capture_ms: float
    pool_bytes: int

    def replay(self) -> None:
        """One replay on the current stream, its launches counted."""
        self.graph.replay()
        for (owner, attr), n in zip(launch_counters(), self.per_replay):
            if n:
                setattr(owner, attr, getattr(owner, attr) + n)


def capture(run: Callable, stream: torch.cuda.Stream, device: torch.device, what: str,
            generators: tuple[torch.Generator, ...] = ()) -> Graph:
    """``run()`` captured on ``stream``; ``what`` names it in a failure.

    The draws ``run`` makes from ``generators`` are captured with it: each
    replay draws from the generator's seed and offset at that replay, the
    numbers an eager call would draw from that state."""
    before = launch_counts()
    graph = torch.cuda.CUDAGraph()
    for generator in generators:
        graph.register_generator_state(generator)
    current = torch.cuda.current_stream(device)
    failure, out = None, None
    torch.cuda.synchronize(device)
    reserved = torch.cuda.memory_reserved(device)
    t0 = time.perf_counter()
    stream.wait_stream(current)
    debug = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = run()
            except Exception as exc:  # reported below, after the capture is closed
                failure = exc
            finally:
                try:
                    graph.capture_end()
                except RuntimeError as exc:
                    failure = failure or exc
    finally:
        torch.cuda.set_sync_debug_mode(debug)
    current.wait_stream(stream)
    after = launch_counts()
    for (owner, attr), n in zip(launch_counters(), before):
        setattr(owner, attr, n)  # recorded, not run
    if failure is not None:
        raise GraphCaptureError(f"capture of {what} failed at {where(failure)}: "
                                f"{failure}") from failure
    return Graph(graph, out, [a - b for a, b in zip(after, before)],
                 (time.perf_counter() - t0) * 1e3, torch.cuda.memory_reserved(device) - reserved)


class GraphCache:
    """``fn(*tensors) -> tensor`` as one CUDA graph per input signature.

    On a CUDA ``device`` the first call of a signature (``signature(*inputs,
    static=static)``) copies the inputs into static buffers, warms ``fn`` up
    on them, captures it and replays it; every later call of that signature
    copies its inputs into the buffers and replays. Each call returns a
    fresh tensor (a clone of the static output), so a later call leaves an
    earlier result as it was. Each signature keeps its graph and its pool
    for the life of the cache, as ``jax.jit`` keeps its programs; calls are
    serialised, and run on the caller's current stream.

    ``generator``, the one that ``fn`` draws from, is seeded with the call's
    ``seed`` before ``fn`` runs or its graph replays, so a call draws what
    an eager call from a generator seeded with ``seed`` would.

    On any other device ``fn`` runs eagerly, and the cache stays empty.

    ``graphs`` (by signature), ``first_call_ms`` (by signature: host ms of
    the warm-up and the capture) and ``replays`` report the CUDA route.
    Under a profiler a call's parts are the spans ``serving.capture`` or
    ``serving.stage``, then ``serving.replay`` and ``serving.clone``
    (``utils/profiling.py``).
    """

    def __init__(self, fn: Callable, device: str | torch.device, *, name: str,
                 static: tuple = (), generator: torch.Generator | None = None):
        self.fn, self.device, self.name, self.static = fn, torch.device(device), name, static
        self.generator = generator
        self.graphs: dict[tuple, Graph] = {}
        self.first_call_ms: dict[tuple, float] = {}
        self.replays = 0
        self._inputs: dict[tuple, list[torch.Tensor]] = {}
        self._stream: torch.cuda.Stream | None = None
        self._lock = threading.Lock()

    def __call__(self, *inputs: torch.Tensor, seed: int | None = None) -> torch.Tensor:
        with self._lock:
            if self.device.type != "cuda":
                with span("serving.replay"):
                    self._seed(seed)
                    return self.fn(*inputs)
            key = signature(*inputs, static=self.static)
            graph = self.graphs.get(key)
            if graph is None:
                with span("serving.capture"):
                    graph = self._capture(key, inputs)
            else:
                with span("serving.stage"):
                    for buf, x in zip(self._inputs[key], inputs):
                        buf.copy_(x)
            with span("serving.replay"):
                self._seed(seed)
                graph.replay()
            self.replays += 1
            # the static output lives in the graph's pool and is rewritten by the next replay
            with span("serving.clone"):
                return graph.out.clone()

    def _seed(self, seed: int | None) -> None:
        if self.generator is not None:
            self.generator.manual_seed(int(seed))

    def _capture(self, key: tuple, inputs) -> Graph:
        static = [x.clone(memory_format=torch.contiguous_format) for x in inputs]
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        t0 = time.perf_counter()
        warm_up(lambda: self.fn(*static), self._stream, self.device)
        graph = capture(lambda: self.fn(*static), self._stream, self.device,
                        f"{self.name} for {key}",
                        () if self.generator is None else (self.generator,))
        self.first_call_ms[key] = (time.perf_counter() - t0) * 1e3
        self.graphs[key], self._inputs[key] = graph, static
        return graph
