"""Training traffic of a bf16 recipe: ``train_epochs`` as it runs, with one
more number compared and its counters renamed for the bf16 peak.

The run is ``train_epochs.run``'s, step for step: set-up's epoch 1, the
window's scanned epochs, and ``correct`` against the same plain reference
(fp32, TF32 off, fp32-moment Adam). What differs:

* The program's Adam keeps its moments in bf16 (``moment_dtype``). The
  reference resumes the window's last epoch from those moments widened to
  fp32, which is exact, and runs its own fp32 Adam from there.
* ``wstep1_adam_gap``: the window's first step, value by value, against
  the step the reference's Adam makes from the program's moments and the
  program's own gradient (its first moment's change over ``1 - b1``), the
  worst leaf: ``|program - expected|`` over the larger of the expected
  leaf's norm and the median leaf's. It checks the optimizer's arithmetic
  (learning rate, bias corrections, the moments' update) apart from the
  gradient, which ``wgrad1_gap`` holds to the reference's. At a trained
  state the bf16 gradient is a small remainder of large sums and lies
  20-70% from fp32's by leaf (PERF.md, section 2), and Adam passes that on
  to the step: ``wstep1_gap``, the step from the reference's own gradient,
  reads up to ~3 with no fault and cannot tell a doubled learning rate.
* The window's epochs are counted as ``window_epochs``, not ``epochs``, and
  ``compute_dtype`` names the run's dtype, so ``mfu.train`` (the fp32
  peak) finds nothing to read and ``mfu.train_bf16`` reads the window.
"""

from __future__ import annotations

import statistics

import torch

from benchmark.traffic import train_epochs
from benchmark.traffic.train_epochs import UNITS  # noqa: F401 (the harness reads it)


def _widened(state: dict | None) -> dict | None:
    if state is None:
        return None
    return dict(state, m={n: t.float() for n, t in state["m"].items()},
                v={n: t.float() for n, t in state["v"].items()})


@torch.no_grad()
def adam_step_gap(step: dict, expected: dict, leaves) -> float:
    """The worst leaf's ``|step - expected|`` over the larger of the expected
    leaf's norm and the median leaf's."""
    norms = {n: float(expected[n].norm()) for n in leaves}
    floor = statistics.median(norms.values())
    return max(float((step[n] - expected[n]).norm()) / max(norms[n], floor, 1e-30)
               for n in leaves)


def run(run, variants=()):
    """The cell's run (``train_epochs.run``, the same ``variants``)."""
    follow, compare, adam = train_epochs.follow, train_epochs.compare, train_epochs._adam
    readings = train_epochs._Window.readings
    held: dict = {}

    @torch.no_grad()
    def read(window, epoch):  # the program's first window step and gradient, value by value
        b, f = window.begun, window.first
        held["step"] = {n: f["p"][n] - b["p"][n] for n in window.named}
        held["grad"] = {n: (f["m"][n].float() - window.b1 * b["m"][n].float()) / (1 - window.b1)
                        if n in f["m"] else torch.zeros_like(f["p"][n]) for n in window.named}
        return dict(readings(window, epoch), program=True)

    def twin(config, params, epoch, state=None):  # the reference's window Adam, run twice
        if state is not None and held.pop("expect", False):
            m, v, count = state
            start = {n: p.detach().clone() for n, p in params.items()}
            moved = {n: p.clone() for n, p in start.items()}
            adam(config, moved, epoch, ({n: t.clone() for n, t in m.items()},
                                        {n: t.clone() for n, t in v.items()}, count)
                 ).step(moved, held.pop("grad"))
            held["expected"] = {n: moved[n] - start[n] for n in start}
        return adam(config, params, epoch, state)

    def widened(run_, config, weights, state=None, q=None, rows=None):
        held["expect"] = state is not None and q is None and rows is None and "grad" in held
        return follow(run_, config, weights, _widened(state), q, rows)

    def compared(got, want):
        gaps = compare(got, want)
        if got.get("program") and "expected" in held:
            gaps["wstep1_adam_gap"] = adam_step_gap(held["step"], held["expected"],
                                                    train_epochs._moved(want["wgrad1"]))
        return gaps

    saved = (follow, compare, adam, readings)
    train_epochs.follow, train_epochs.compare, train_epochs._adam = widened, compared, twin
    train_epochs._Window.readings = read
    try:
        outcome = train_epochs.run(run, variants)
    finally:
        train_epochs.follow, train_epochs.compare, train_epochs._adam = saved[:3]
        train_epochs._Window.readings = saved[3]
        held.clear()
    counters = outcome.counters
    counters["window_epochs"] = counters.pop("epochs")
    counters["compute_dtype"] = run.config["settings"]["training"]["compute_dtype"]
    return outcome
