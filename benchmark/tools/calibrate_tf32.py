"""The readings that the limits of ``chair_train_fast_tf32`` are set from,
on the card.

    python benchmark/tools/calibrate_tf32.py --seeds 1,2,3 --long-seeds 4,5,6 \\
        --control-seeds 7,8,9 [--seconds 30] [--long-seconds 45] [--out readings.json]

``tools/calibrate.py``'s loop for the TF32 training cell, all in one
process: each seed is the cell's own run (``traffic/train_epochs_tf32.py``)
with a window of ``--seconds`` (``--long-seconds`` for the long seeds, so
that the limits still hold for a program that runs more epochs in the same
window). A control seed runs the program at ``--seconds`` too and then, from
that run's state, the two references that must come out not correct: the
control, the plain reference with both operands of every product rounded to
bf16 (the precision below TF32; ``train_epochs_tf32.bf16``), and the planted
fault "half of the batch left out, the mean taken over the rest". The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[0] = str(ROOT)

from benchmark import harness  # noqa: E402
from benchmark.tools.calibrate import make_run  # noqa: E402

CELL = "chair_train_fast_tf32"


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="")
    ap.add_argument("--long-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--long-seconds", type=float, default=45.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate_tf32 needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    workload, _ = harness.load_cell(CELL)
    driver = harness.load_module(harness.HERE / "traffic" / f"{workload['driver']}.py")
    out: dict = {"workload": CELL, "program": {}, "bf16": {}, "half_batch": {}, "epochs": {},
                 "detail": {}}
    controls = _seeds(args.control_seeds)
    plan = ([(s, args.seconds) for s in _seeds(args.seeds) + controls]
            + [(s, args.long_seconds) for s in _seeds(args.long_seeds)])
    for seed, seconds in plan:
        t = time.perf_counter()
        run = make_run(CELL, seed, seconds, device)
        batch = run.config["settings"]["training"]["dataloader"]["train"]["batch_size"]
        variants = ([("bf16", driver.bf16, None), ("half_batch", None, slice(0, batch // 2))]
                    if seed in controls else [])
        outcome = driver.run(run, variants)
        for name, gaps in outcome.counters["variants"].items():
            out[name][seed] = gaps
            print(f"{name} seed {seed}: {gaps}", flush=True)
        out["program"][seed] = {c.name: c.value for c in outcome.checks}
        out["epochs"][seed] = outcome.counters["window_epochs"]
        out["detail"][seed] = outcome.counters["detail"]
        print(f"program seed {seed} at {seconds} s: {out['program'][seed]} "
              f"({out['epochs'][seed]} window epochs, {outcome.counters['compute_dtype']}, "
              f"{outcome.counters['matmul_precision']}, "
              f"{outcome.metrics['train_clouds_per_s']:.1f} clouds/s, "
              f"{time.perf_counter() - t:.1f} s)", flush=True)
        print(f"  detail: {outcome.counters['detail']}", flush=True)
    limits = workload["params"]["limits"]
    for kind in ("program", "bf16", "half_batch"):
        for name in sorted({k for r in out[kind].values() for k in r}):
            vals = [r[name] for r in out[kind].values()]
            over = sum(v > limits.get(name, float("inf")) for v in vals)
            print(f"{kind} {name}: min {min(vals)!r} max {max(vals)!r} over {len(vals)} seeds, "
                  f"{over} above the limit {limits.get(name)!r}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
