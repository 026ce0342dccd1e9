"""Scanned epochs (``epoch_mode: "scan"``): an epoch's batches as replays of one CUDA graph.

The machinery behind ``train/trainer.py::make_train_epoch_scan`` and
``make_val_epoch_scan``, the port's counterparts of the JAX package's
``lax.scan`` of the step body over an epoch's stacked batches
(``hyperpocket_tpu/train/trainer.py::make_train_epoch_scan``,
``make_val_epoch_scan``: one dispatch an epoch). ``EpochScan(body, ...)``
is called as ``epoch_fn(existing, missing, gt, generators, epoch,
num_points)`` with the prefix stacked on the device, (S, B, N, 3) each
(``upload_stacked`` puts it there in one host-to-device copy), and one
seeded generator a step; it returns the S rows the body reports, stacked,
and the last step's reconstruction.

On a CUDA device the body (the train step: forward, backward, gradient
all-reduce and optimizer update; or the val step: forward and loss) is
captured into a ``torch.cuda.CUDAGraph`` over static buffers and replayed
once a step: the host issues a replay, the copies of the step's batch and
its two draws, where an eager step issues hundreds of launches. On the CPU
the same call runs the body eagerly on the same buffers.

* Draws and inputs: before each replay the host copies batch s into the
  static inputs and makes the step's two draws from its generator into the
  static ``vae_eps``/``ball_points`` (``FullModel.random_inputs``, in the
  order ``apply`` draws them), so the trajectory is the step loop's. A copy
  an input (0.8-1.6 MB at B=64, device to device) keeps the captured body
  the step function itself; a step index kept on the device would need a
  body that indexes the stacked epoch, which the step function does not.
* The kept graph: each ``EpochScan`` keeps its latest graph, with its
  static buffers, from one call to the next, and captures anew only where
  the call's ``signature`` differs from the kept one's: the compute dtype,
  the point count and the buffers' shapes and dtypes; the switches the
  step's routes read (deterministic algorithms, fp32 matmul precision);
  every parameter group's hyperparameters (the learning rate, betas, eps,
  weight decay, ...: host floats in the captured kernels); and the
  addresses of the parameters and of the optimizer's state, which the
  kernels read and write. The body never reads ``epoch`` (the draws that
  depend on it are made outside the graph). So a learning rate that
  changes only at a ``StepLR`` step recaptures once, at that epoch, and a
  ``compute_dtype_switch`` at the switch; a rate that changes every epoch
  recaptures every epoch. One graph an ``EpochScan``: the old one goes
  before the new capture. ``release()`` drops it, for a caller that
  changes what the signature cannot see (a route patched in).
* Each call's first step copies batch 0 and draw 0 into the kept buffers
  (into fresh ones where it captures for new shapes).
* Warm-up: cuBLAS, NCCL and the optimizer make their state at first use,
  which a capture must not record. The first capture of each dtype and set
  of shapes rehearses the body eagerly first, on the capture's stream
  (``utils/cuda_graph.py::warm_up``), then puts back the parameters and the
  optimizer's state; slots the rehearsal created are zeroed, which is each
  optimizer's state before its first update (``train/optim.py``; SGD's
  momentum from zero equals its first-step copy of the gradient).
  ``rehearsals`` counts them; their launches ran on the card and stay
  counted.
* Capture, launch counts and failure are ``utils/cuda_graph.py``'s: each
  ``.launches`` counts the launches the card ran, replays included
  (``launches_per_replay`` holds a replay's), and a capture that fails
  raises ``GraphCaptureError`` naming the line of the body where it arose.
  Nothing falls back to the step loop.
* Spans (``utils/profiling.py``, under a profiler): ``scan.rehearse``,
  ``scan.capture``, and a step's ``scan.fill`` (its batch and draws into
  the static buffers) and ``scan.replay``. A call that replays a kept graph
  counts ``scan.kept`` and adds again the counters its capture tallied
  (``profiling.collected``: ``adam_lowp.values``,
  ``encoder.trunk_route.<route>``), so each scanned call under a profiler
  counts a step's routes and values once, whether it captured or not.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from hyperpocket_tpu_torch.ops import launch_counters
from hyperpocket_tpu_torch.utils.cuda_graph import Graph, GraphCaptureError, capture, warm_up
from hyperpocket_tpu_torch.utils.profiling import collected, count, recording, recount, span

__all__ = ["EpochScan", "GraphCaptureError", "upload_stacked"]

_ALIGN = 64  # bytes between the stacked arrays in the upload buffer


class _Kept(NamedTuple):
    """An ``EpochScan``'s latest graph: its ``signature``, the graph, its
    static buffers and the counters its capture tallied."""

    key: tuple
    graph: Graph
    static: dict
    counts: dict


def upload_stacked(parts: list[list[np.ndarray]], device: torch.device) -> list[torch.Tensor]:
    """Each list of equal-shaped arrays stacked to (S, ...) on ``device``.

    The stacks are written once into one host buffer (pinned on a card) and
    reach the device in one copy; each keeps its arrays' dtype.
    """
    device = torch.device(device)
    shapes = [(len(p), *np.shape(p[0])) for p in parts]
    dtypes = [np.result_type(*p) for p in parts]
    sizes = [int(np.prod(s)) * np.dtype(d).itemsize for s, d in zip(shapes, dtypes)]
    offsets = [0]
    for n in sizes:
        offsets.append(offsets[-1] + -(-n // _ALIGN) * _ALIGN)
    host = torch.empty(offsets[-1], dtype=torch.uint8, pin_memory=device.type == "cuda")
    buf = host.numpy()
    for p, shape, dt, off, n in zip(parts, shapes, dtypes, offsets, sizes):
        np.stack(p, out=buf[off:off + n].view(dt).reshape(shape))
    dev = host.to(device, non_blocking=True)
    return [dev[off:off + n].view(torch.from_numpy(np.empty(0, dt)).dtype).view(shape)
            for shape, dt, off, n in zip(shapes, dtypes, offsets, sizes)]


class EpochScan:
    """One step body run over an epoch's stacked batches.

    ``body(existing, missing, gt, epoch, num_points, vae_eps, ball_points)
    -> (row, rec)`` is one step on the static buffers; ``row`` (the step's
    losses) and ``rec`` are its outputs. ``draw_rows`` multiplies a batch's
    rows into the batch the draws are made for (the data axis of a mesh,
    whose ranks draw the global batch). ``optimizer``, when the body updates
    parameters, is what a rehearsal puts back.

    On a card the latest capture's graph and static buffers are kept and
    replayed by every later call of the same ``signature`` (see the module's
    docstring). ``replays``, ``captures``, ``reuses`` (calls that replayed a
    kept graph), ``rehearsals``, ``capture_ms`` (host ms of this call's
    capture, from an idle card, instantiation included; None where the call
    replayed a kept graph) and ``launches_per_replay`` report the CUDA
    route; the CPU route runs the body eagerly and leaves them.
    """

    def __init__(self, body: Callable, *, model, optimizer=None, draw_rows: int = 1,
                 name: str = "step"):
        self.body, self.model, self.optimizer = body, model, optimizer
        self.draw_rows, self.name = draw_rows, name
        self.replays = self.captures = self.reuses = self.rehearsals = 0
        self.capture_ms: float | None = None
        self._per_replay: list[int] = []  # each launch counter's launches a replay
        self._rehearsed: set = set()
        self._stream: torch.cuda.Stream | None = None
        self._kept: _Kept | None = None

    def __call__(self, existing: torch.Tensor, missing: torch.Tensor | None, gt: torch.Tensor,
                 generators: list, epoch, num_points: int):
        steps = existing.shape[0]
        if len(generators) != steps:
            raise ValueError(f"{steps} stacked batches but {len(generators)} generators")
        stacked = {"existing": existing, "missing": missing, "gt": gt}
        batch = existing.shape[1] * self.draw_rows

        def draw(s):
            return self.model.random_inputs(generators[s], batch, num_points, epoch)

        kept = self._kept
        with span("scan.fill"):  # step 0's batch and draws into the static buffers
            first = {k: None if v is None else v[0] for k, v in stacked.items()}
            first["vae_eps"], first["ball_points"] = draw(0)
            shapes = self._shapes(first, num_points)
            if kept is not None and kept.key[0] == shapes:
                static = kept.static
                for k, v in first.items():
                    if v is not None:
                        static[k].copy_(v)
            else:
                static = {k: v if v is None or k not in stacked else v.clone()
                          for k, v in first.items()}

        def fill(s):
            with span("scan.fill"):
                for k, v in stacked.items():
                    if v is not None:
                        static[k].copy_(v[s])
                for k, v in zip(("vae_eps", "ball_points"), draw(s)):
                    if v is not None:
                        static[k].copy_(v)

        def run():
            return self.body(static["existing"], static["missing"], static["gt"], epoch,
                             num_points, static["vae_eps"], static["ball_points"])

        if existing.device.type != "cuda":
            rows = rec = None
            for s in range(steps):
                if s:
                    fill(s)
                with span("scan.replay"):
                    row, rec = run()
                rows = row.new_empty((steps, *row.shape)) if rows is None else rows
                rows[s] = row
            return rows, rec

        device = existing.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        if kept is not None and kept.static is not static:  # other shapes: its pool goes first
            self._kept = kept = None
        if shapes not in self._rehearsed:
            with span("scan.rehearse"):
                self._rehearse(run, device)
            self._rehearsed.add(shapes)
        key = self.signature(static, num_points)
        if kept is not None and kept.key == key:
            self.reuses += 1
            self.capture_ms = None
            if recording():
                count("scan.kept")
                recount(kept.counts)
        else:
            self._kept = kept = None  # the old graph's pool goes before the capture
            with span("scan.capture"), collected() as counts:
                graph = capture(run, self._stream, device, f"the {self.name} step")
            self._kept = kept = _Kept(key, graph, static, counts)
            self.capture_ms = graph.capture_ms
            self.captures += 1
            self._per_replay = graph.per_replay
        graph = kept.graph
        row, out = graph.out
        rows = torch.empty((steps, *row.shape), dtype=row.dtype, device=device)
        for s in range(steps):
            if s:
                fill(s)
            with span("scan.replay"):
                graph.replay()
                rows[s].copy_(row)
        self.replays += steps
        # the static output lives in the graph's pool and is rewritten by its next replay
        return rows, out.clone()

    def _shapes(self, static: dict, num_points: int) -> tuple:
        """The compute dtype, the point count and each static buffer's shape
        and dtype: what a rehearsal is made once for."""
        return (self.model.compute_dtype, num_points,
                tuple((k, None if v is None else (tuple(v.shape), v.dtype))
                      for k, v in static.items()))

    def signature(self, static: dict, num_points: int) -> tuple:
        """The key a kept graph is replayed under: what its capture bakes in.

        ``static`` (the step's buffers by name) and ``num_points`` give the
        shapes (``_shapes``); then the switches the step's routes read, each
        parameter group's hyperparameters (``params`` aside; a tensor one by
        its address, which the kernels read), and the addresses of the
        model's parameters and of the optimizer's state tensors.
        """
        groups = self.optimizer.param_groups if self.optimizer is not None else []
        state = self.optimizer.state if self.optimizer is not None else {}
        hyper = tuple(tuple((k, v.data_ptr() if torch.is_tensor(v) else v)
                            for k, v in sorted(group.items()) if k != "params")
                      for group in groups)
        tensors = [*self.model.parameters(),
                   *(v for group in groups for p in group["params"]
                     for v in state.get(p, {}).values() if torch.is_tensor(v))]
        return (self._shapes(static, num_points),
                (torch.are_deterministic_algorithms_enabled(),
                 torch.get_float32_matmul_precision()),
                hyper, tuple(t.data_ptr() for t in tensors))

    def release(self) -> None:
        """Drop the kept graph and its buffers: the next call captures anew."""
        self._kept = None

    @property
    def launches_per_replay(self) -> dict[str, int]:
        """The kernels one replay launches, by wrapper (and counter) name."""
        return {owner.__name__ + ("" if attr == "launches" else f".{attr}"): n
                for (owner, attr), n in zip(launch_counters(), self._per_replay) if n}

    @torch.no_grad()
    def _rehearse(self, run: Callable, device: torch.device) -> None:
        """Run the body once eagerly on the capture stream, then put back the
        parameters and the optimizer's state (slots it created: zeros)."""
        groups = self.optimizer.param_groups if self.optimizer is not None else []
        params = [p for group in groups for p in group["params"]]
        saved = [p.detach().clone() for p in params]
        state = self.optimizer.state if self.optimizer is not None else {}
        kept = {p: {k: v.clone() for k, v in state[p].items() if torch.is_tensor(v)}
                for p in params if p in state}
        with torch.enable_grad():
            warm_up(run, self._stream, device)
        for p, v in zip(params, saved):
            p.copy_(v)
        for p in params:
            for k, v in state.get(p, {}).items():
                if k in kept.get(p, {}):
                    v.copy_(kept[p][k])
                elif torch.is_tensor(v):
                    v.zero_()
        self.rehearsals += 1
