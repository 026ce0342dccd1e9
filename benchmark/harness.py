"""One run of one cell: find its files by name, drive it, print the result.

``main`` is what ``run.py`` calls. It checks for the card before anything
else, so a machine without one prints no result. ``execute`` drives a cell
on any device and returns the result; the tests call it on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import json
import logging
import math
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hyperpocket_tpu")  # top-level module names


@dataclasses.dataclass
class Check:
    """A number compared with its limit: the run is correct only where
    every value is at most its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a traffic driver hands back."""
    attempted: int
    failed: int
    metrics: dict  # end-to-end metric name -> value (setup_s included)
    checks: list  # [Check]
    memory_peak_bytes: int
    counters: dict  # what the per-layer readers read beside the trace
    trace: object = None  # trace.Summary of the traced window, or None


@dataclasses.dataclass
class Run:
    """Everything a traffic driver gets."""
    cell: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    t0: float  # perf_counter at process start
    root: Path  # the benchmark's directory
    marks: list = dataclasses.field(default_factory=list)  # [(stage, s from t0)]

    @property
    def params(self) -> dict:
        return self.workload["params"]

    def mark(self, stage: str) -> None:
        """The end of a stage of set-up, printed on stderr with the result."""
        self.marks.append((stage, time.perf_counter() - self.t0))

    def sub_seed(self, tag: str) -> int:
        return sub_seed(self.seed, tag)


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path):
    """A module of the benchmark loaded from its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"bench_{path.stem.replace('.', '_')}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str, root: Path = HERE) -> tuple[dict, dict]:
    """(workload, configuration) of the cell ``name``."""
    workload = load_json(root / "workloads" / f"{name}.json")
    config = load_json(root / "configs" / f"{workload['config']}.json")
    return workload, config


def read_per_layer(outcome: Outcome, root: Path = HERE) -> dict:
    """Every reader under ``metrics/`` on the traced window; a reader that
    finds nothing to read returns None and its metric is left out."""
    out = {}
    for path in sorted((root / "metrics").glob("*.py")):
        if path.name.startswith("_"):
            continue
        reader = load_module(path)
        value = reader.read(outcome.trace, outcome.counters)
        if value is not None:
            out[path.stem] = {"value": float(value), "unit": reader.UNIT}
    return out


def execute(name: str, seed: int, seconds: float, trace: bool, device, t0: float,
            root: Path = HERE, marks: list | None = None) -> tuple[Outcome, dict]:
    """Drive the cell ``name`` on ``device``; returns (outcome, metrics).
    ``marks`` are the stages of set-up already passed."""
    workload, config = load_cell(name, root)
    driver = load_module(root / "traffic" / f"{workload['driver']}.py")
    run = Run(name, workload, config, int(seed), float(seconds), bool(trace), device, t0, root,
              list(marks or []))
    outcome = driver.run(run)
    stages = ", ".join(f"{stage} {s:.3f}" for stage, s in run.marks)
    outcome.counters["notes"] = [f"set-up stages, s from the start: {stages}",
                                 *outcome.counters.get("notes", [])]
    if trace:
        metrics = read_per_layer(outcome, root)
    else:
        metrics = {k: {"value": float(v), "unit": driver.UNITS[k]}
                   for k, v in outcome.metrics.items()}
    return outcome, metrics


def loaded_forbidden(modules=None) -> list[str]:
    """The loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``hyperpocket_tpu_torch`` is not ``hyperpocket_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def result_line(outcome: Outcome, metrics: dict, device_info: dict) -> dict:
    """The contract's line: ``checks`` last, each value beside its limit."""
    line = {"correct": all(c.ok for c in outcome.checks) and bool(outcome.checks),
            "attempted": outcome.attempted, "failed": outcome.failed, "metrics": metrics,
            "device": device_info}
    if outcome.trace is not None:
        line["breakdown"] = {"device_ops": outcome.trace.device_ops,
                             "idle_gaps": outcome.trace.idle_gaps}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return line


def quiet_logging() -> None:
    """Drop what the program's logging set up (a DEBUG root logger writing
    to a file of its run), so that the exit writes nothing after the checks."""
    root = logging.getLogger()
    for handler in list(root.handlers):
        root.removeHandler(handler)
        handler.close()
    root.setLevel(logging.WARNING)
    logging.getLogger("torch").setLevel(logging.WARNING)


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark on the card")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    workload, _ = load_cell(args.workload)
    chips = int(workload.get("chips", 1))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    outcome, metrics = execute(args.workload, args.seed, args.seconds, bool(args.trace), device,
                               t0, marks=[("import torch", time.perf_counter() - t0)])
    quiet_logging()
    found = loaded_forbidden()
    if found:
        print(f"no result: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(outcome.memory_peak_bytes),
            "power_limit_w": power_limit_w()}
    if outcome.trace is not None:
        info["busy_s"] = outcome.trace.busy_s
        info["window_s"] = outcome.trace.window_s
    line = result_line(outcome, metrics, info)
    for note in outcome.counters.get("notes", []):
        print(note, file=sys.stderr)
    for c in outcome.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0
