"""The readings that each ``correct`` limit is set from, on the card.

    python benchmark/tools/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--out readings.json]

For each seed the program's reading: the cell's own run, in this process,
with a window of ``--seconds`` (by default just long enough to fill the
run's sample, or one window epoch). For each control seed the control's
reading: the plain reference rounded to the precision below the
configuration's (fp8 below bf16, TF32 below fp32 with TF32 off) in the
program's place; for a training cell also the planted fault "half of the
batch left out, the mean taken over the rest" in the reference, both from
the same run's state (a control seed of a training cell runs the program
too). The benchmark's own runs never run this.
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
from benchmark.reference import quant  # noqa: E402

BELOW = {"bfloat16": quant.fp8, "float32": quant.tf32}


def make_run(name: str, seed: int, seconds: float, device):
    workload, config = harness.load_cell(name)
    return harness.Run(name, workload, config, seed, seconds, False, device,
                       time.perf_counter(), harness.HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    workload, _ = harness.load_cell(args.workload)
    driver = harness.load_module(harness.HERE / "traffic" / f"{workload['driver']}.py")
    train = workload["driver"] == "train_epochs"
    out = {"workload": args.workload, "program": {}, "control": {}, "half_batch": {}}
    seconds = args.seconds if args.seconds is not None else 0.0 if train else 0.5
    controls = [int(s) for s in args.control_seeds.split(",")]
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds + ([s for s in controls if s not in seeds] if train else []):
        t = time.perf_counter()
        run = make_run(args.workload, seed, seconds, device)
        if train:
            batch = run.config["settings"]["training"]["dataloader"]["train"]["batch_size"]
            variants = ([("control", quant.tf32, None), ("half_batch", None,
                                                         slice(0, batch // 2))]
                        if seed in controls else [])
            outcome = driver.run(run, variants)
            for name, gaps in outcome.counters["variants"].items():
                out[name][seed] = gaps
                print(f"{name} seed {seed}: {gaps}", flush=True)
        else:
            outcome = driver.run(run)
        if seed in seeds:
            out["program"][seed] = {c.name: c.value for c in outcome.checks}
        print(f"program seed {seed}: {({c.name: c.value for c in outcome.checks})} "
              f"({outcome.counters.get('epochs', outcome.counters.get('calls'))} window "
              f"epochs or calls, {time.perf_counter() - t:.1f} s)", flush=True)
        if "detail" in outcome.counters:
            out.setdefault("detail", {})[seed] = outcome.counters["detail"]
            print(f"  detail: {outcome.counters['detail']}", flush=True)
    for seed in [] if train else controls:
        run = make_run(args.workload, seed, 0.0, device)
        q = BELOW[run.params["compute_dtype"]]
        out["control"][seed] = {"rel_gap": driver.control(run, q)}
        print(f"control seed {seed}: {out['control'][seed]}", flush=True)
    for kind in ("program", "control", "half_batch"):
        names = sorted({k for r in out[kind].values() for k in r})
        for name in names:
            vals = [r[name] for r in out[kind].values()]
            print(f"{kind} {name}: min {min(vals)!r} max {max(vals)!r} over {len(vals)} seeds")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
