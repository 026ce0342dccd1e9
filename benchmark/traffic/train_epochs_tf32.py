"""Training traffic of the fast recipe past its ``compute_dtype_switch``:
``train_epochs_bf16`` as it runs, with the precision the program ran in
read from the program, and the forward compared from a state that does
not depend on the window's length.

The configuration starts in bf16 and switches to fp32 with TF32 matmuls
("high") at an epoch that set-up's epoch 1 already crosses, through the
program's own epoch routine (``Trainer.train_epoch``). The run is
``train_epochs_bf16.run``'s, step for step: the same plain reference (fp32,
TF32 off, fp32-moment Adam), resumed for the window's last epoch from the
program's bf16 moments widened to fp32, ``wstep1_adam_gap`` included.
What differs:

* The numbers read at the window's last epoch. It lies further into
  training the faster the program is, and the gap of a loss grows with
  training (a trained cloud's distances are small remainders), so its
  first step's loss (``wloss1_gap``) and its val steps (``val_gap``) are
  not compared here; nor is its gradient (``wgrad1_gap``), which is
  rebuilt from bf16 moments and reads sound runs as far out as half a
  batch (PERF.md, section 2). Its step is (``wstep1_gap``,
  ``wstep1_adam_gap``), and its val gaps stay in ``detail``.
* Epoch 1's val, from the parameters set-up's epoch 1 left (the same
  state in every run, traced or not, whatever the window), against the
  reference's from the same parameters and draws: ``val1_gap``, the worst
  step's ``|loss - ref| / |ref|``, and ``rec1_tf32_ratio``: the
  reconstructions of the last scanned step and of the ragged tail step,
  ``|rec - ref|`` over all their points, over the same distance for the
  reference with its products' operands rounded to TF32 (the
  configuration's precision, ``reference/quant.py``). The ratio takes out
  how sensitive a state is to rounding, which differs from seed to seed
  several times over: TF32 reads about 1 at any state, bf16 operands
  several times more.
* ``compute_dtype`` and ``matmul_precision`` in the counters are what the
  program ran: the model's compute dtype after set-up and
  ``torch.get_float32_matmul_precision()``, never the configuration's. So
  ``mfu.train`` (no ``epochs``) and ``mfu.train_bf16`` (not bf16) read
  nothing here, and ``mfu.train_tf32`` reads the window.
* One more check, ``bf16_epochs``: the run's train epochs (set-up's
  included) that the program counted under ``trainer.compute_dtype.bfloat16``
  (``utils/profiling.py``, tallied into a ``collected()`` around the whole
  run, profiled or not). A program that counts no epoch under any dtype
  cannot show that it crossed the switch, and the run stops after set-up
  with an error.
* ``bf16``: the control's rounding, both operands of every product in the
  reference to bf16 (8 bits of mantissa against TF32's 11), for
  ``tools/calibrate_tf32.py``.
"""

from __future__ import annotations

import torch

from benchmark.harness import Check
from benchmark.reference import model as ref
from benchmark.reference import quant
from benchmark.traffic import train_epochs, train_epochs_bf16
from benchmark.traffic.train_epochs import UNITS  # noqa: F401 (the harness reads it)

COUNTER = "trainer.compute_dtype."
LEFT_OUT = ("wloss1_gap", "wgrad1_gap", "val_gap")  # see above


def bf16(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to bf16 (to nearest even) and back."""
    return x.float().to(torch.bfloat16).float()


def _distance(got: list, want: list) -> float:
    return sum(float((a.double() - b.double()).square().sum()) for a, b in zip(got, want)) ** 0.5


def val1_gaps(got: dict, want: dict) -> dict:
    """``val1_gap`` and ``rec1_tf32_ratio`` of epoch 1's val."""
    if len(got["val1"]) != len(want["val1"]) or not want["val1"] or [
            r.shape for r in got["rec1"]] != [r.shape for r in want["rec1"]]:
        return dict.fromkeys(("val1_gap", "rec1_tf32_ratio"), float("inf"))
    return {"val1_gap": train_epochs._steps_gap(got["val1"], want["val1"]),
            "rec1_tf32_ratio": _distance(got["rec1"], want["rec1"])
            / max(_distance(want["rec1_tf32"], want["rec1"]), 1e-30)}


def follow_val1(plan, params: dict, steps: list, q=None, rows: slice | None = None,
                losses: bool = True):
    """The reference's epoch-1 val from ``params``: every step's loss
    (unless not ``losses``) and the reconstructions of the steps ``steps``
    (whole: ``rows`` leaves them as they are)."""
    train, val, counter = plan.epoch(1)
    counter += len(train)
    model, coef = plan.config["full_model"], float(plan.config["training"]["loss_coef"])
    device = next(iter(params.values())).device
    out, recs = [], []
    with torch.no_grad(), ref.fp32_highest():
        for j, idx in enumerate(val):
            if not losses and j not in steps:
                continue
            ex, mi, gt, _, balls = plan.step(idx, counter + j + 1, 1, device)
            if losses:
                out.append(float(ref.val_loss(params, model, ex, mi, gt, balls, coef, q, rows)))
            if j in steps:
                noise = (ref.encoder(params, "random_encoder", mi, q)[0]
                         if int(model["random_encoder"]["output_size"]) > 0 else None)
                recs.append(ref.complete(params, model, ex, noise, balls, q).cpu())
    return out, recs


def run(run, variants=()):
    """The cell's run (``train_epochs.run``, the same ``variants``)."""
    from hyperpocket_tpu_torch.utils import profiling

    first_epoch, follow, compare = (train_epochs._first_epoch, train_epochs.follow,
                                    train_epochs.compare)
    ran: dict = {}
    held: dict = {}

    def first(trainer, named, weights):  # epoch 1, its val and the parameters it left
        losses, recs = [], []
        val_scan, val_step = trainer._val_epoch_scan_fn, trainer.val_step

        def kept(fn):
            def call(*args, **kwargs):
                loss, rec = fn(*args, **kwargs)
                losses.append(loss.reshape(-1))
                recs.append((sum(len(x) for x in losses) - 1, rec.detach().float().clone()))
                return loss, rec
            return call

        trainer._val_epoch_scan_fn, trainer.val_step = kept(val_scan), kept(val_step)
        try:
            seen = first_epoch(trainer, named, weights)
        finally:
            trainer._val_epoch_scan_fn, trainer.val_step = val_scan, val_step
        seen["val1"] = [float(x) for x in torch.cat(losses).cpu()]
        seen["rec1"] = [r.cpu() for _, r in recs]
        held["steps"] = [j for j, _ in recs]
        # the parameters epoch 1 left, copied off the card (no share of its peak)
        held["end1"] = {n: q.detach().to("cpu", copy=True) for n, q in named.items()}
        if not any(k.startswith(COUNTER) for k in counts):
            raise RuntimeError(f"the program counted no train epoch under {COUNTER}<dtype>: "
                               "it cannot show which dtype its epochs ran in")
        ran.update(compute_dtype=trainer.model.compute_dtype,
                   matmul_precision=torch.get_float32_matmul_precision())
        return seen

    def followed(run_, config, weights, state=None, q=None, rows=None):
        out = follow(run_, config, weights, state, q, rows)
        if "plan" not in held:
            held["plan"] = train_epochs._Plan(run_, config)
        device = next(iter(weights.values())).device
        end = {n: t.to(device) for n, t in held["end1"].items()}
        out["val1"], out["rec1"] = follow_val1(held["plan"], end, held["steps"], q, rows)
        if q is None and rows is None:  # the reference the others are compared with
            out["rec1_tf32"] = follow_val1(held["plan"], end, held["steps"], quant.tf32,
                                           losses=False)[1]
        return out

    def compared(got, want):
        gaps = compare(got, want)
        for name in LEFT_OUT:
            gaps.pop(name, None)
        gaps.update(val1_gaps(got, want))
        return gaps

    train_epochs._first_epoch, train_epochs.follow, train_epochs.compare = (first, followed,
                                                                            compared)
    try:
        with profiling.collected() as counts:
            outcome = train_epochs_bf16.run(run, variants)
    finally:
        train_epochs._first_epoch, train_epochs.follow, train_epochs.compare = (first_epoch,
                                                                                follow, compare)
        held.clear()
    outcome.checks.append(Check("bf16_epochs", float(counts.get(COUNTER + "bfloat16", 0)),
                                run.params["limits"]["bf16_epochs"]))
    outcome.counters.update(ran)
    return outcome
