"""Training traffic: ``Trainer`` with ``epoch_mode: "scan"`` runs train and
val epochs in turn, as ``Trainer.run`` does, without plots or checkpoints.

Set-up builds the one Trainer of the run from the configuration (the
corpus written once into the checkout, ``setup.seed`` the run's seed), puts
the benchmark's weights into its model, and runs epoch 1 (train, then val)
through the same calls as the window: it reads the dataset into the cache,
rehearses and captures the graphs, and its first three steps are the ones
the reference follows. The window runs epochs 2, 3, ... and ends at the end
of the last epoch started before ``--seconds`` ran out.

Parameters: ``corpus`` (``shapes``, ``samples``, ``n_gt``, ``n_partial``,
``corpus_seed``), ``trace_epochs`` (the traced window ends after that many
epochs at the latest) and ``limits``.

``correct``, against the plain reference (fp32, TF32 off) with the same
weights, corpus, batches, draws and learning rate, each worked out from the
configuration:

* Epoch 1, from the benchmark's weights: the first step's loss
  (``loss1_gap``; the second and third steps' losses carry the round-off
  that Adam's first steps amplify, PERF.md), the first gradient as Adam
  received it, from its first moment after one step (``grad1_gap``), and
  the parameters' change after three steps as the fourth finds them
  (``delta3_gap``).
* The window's last epoch, from the program's parameters and Adam moments
  as that epoch began (copied on the card at the start of every window
  epoch, since only its end shows which is the last): its first step's
  loss (``wloss1_gap``), the gradient Adam received there, from the change
  of its first moment (``wgrad1_gap``), the change that step made to the
  parameters, with Adam's count the reference works out
  (``wstep1_gap``), and every val step's loss of that epoch from the
  parameters the train epoch left (``val_gap``, the worst step).

A loss's gap is ``|loss - ref| / |ref|``. A leaf's gap is
``| |program| - |ref| |`` over the larger of the reference leaf's norm and
the median leaf's, the worst leaf compared. Leaves whose reference gradient
is under a thousandth of the median leaf's (the real encoder's unused
``std`` head) move by round-off alone and are left out of the changes.
"""

from __future__ import annotations

import copy
import gc
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.counts import model as counts
from benchmark.harness import Check, Outcome
from benchmark.reference import model as ref
from benchmark.trace import WINDOW, profiled, spanned

UNITS = {"setup_s": "s", "train_clouds_per_s": "clouds/s"}
STEPS_FOLLOWED = 3
DEAD_LEAF = 1e-3  # a reference gradient under this share of the median leaf's


class _Watched(list):
    """The epoch's generators; ``hook(s)`` runs when step ``s``'s draw is
    first made, which is after step ``s - 1`` has been issued."""

    def __init__(self, items, hook):
        super().__init__(items)
        self._hook, self._seen = hook, set()

    def __getitem__(self, s):
        if isinstance(s, int) and s not in self._seen:
            self._seen.add(s)
            self._hook(s)
        return super().__getitem__(s)


def settings(run, corpus, results) -> dict:
    config = copy.deepcopy(run.config["settings"])
    config["dataset"]["path"] = str(corpus)
    config["setup"]["seed"] = run.seed
    config["results_root"] = str(results)
    return config


def run(run, variants=()) -> Outcome:
    """The cell's run. ``variants`` ((name, q, rows), ...) puts the reference
    made with that quantizer or those rows in the program's place and
    reports its gaps under ``counters["variants"]``: the controls and
    faults that ``tools/calibrate.py`` reads."""
    from hyperpocket_tpu_torch.train.trainer import Trainer

    run.mark("import program")
    p = run.params
    corpus = inputs.ensure_corpus(run.root / ".corpus", p["corpus"])
    run.mark("corpus")
    results = tempfile.mkdtemp(prefix="bench_train_")
    try:
        config = settings(run, corpus, results)
        model_cfg = config["full_model"]
        trainer = Trainer(config, device=run.device)
        run.mark("Trainer")
        weights = inputs.make_weights(model_cfg, run.sub_seed("weights"), run.device)
        named = dict(trainer.model.named_parameters())
        if set(named) != set(weights):
            raise RuntimeError(f"the model's parameters {sorted(set(named) ^ set(weights))} "
                               "are not the published layout's")
        with torch.no_grad():
            for name, param in named.items():
                param.copy_(weights[name])
        run.mark("weights")
        observed = _first_epoch(trainer, named, weights)
        run.mark("epoch 1")
        scans = (trainer._epoch_scan_fn, trainer._val_epoch_scan_fn)  # before _Window wraps them
        window = _Window(trainer, named)
        setup_s = time.perf_counter() - run.t0

        epochs = steps = failed = clouds = flops = 0
        capture_ms = []
        batch = config["training"]["dataloader"]["train"]["batch_size"]
        n_gt, n_part = p["corpus"]["n_gt"], p["corpus"]["n_partial"]
        train_flops = counts.train_flops_a_cloud(model_cfg, n_part, n_part, n_gt)
        val_flops = counts.val_flops_a_cloud(model_cfg, n_part, n_gt)
        val_items = sum(len(loader.dataset) for loader in trainer.val_loaders.values())
        limit = p["trace_epochs"] if run.trace else None
        if run.trace:  # spans around the Trainer's parts of an epoch
            for attr, name in (("_collect", "Trainer._collect (loader)"),
                               ("_stacked", "Trainer._stacked (upload)"),
                               ("_epoch_scan_fn", "train EpochScan (capture, replays)"),
                               ("_val_epoch_scan_fn", "val EpochScan (capture, replays)"),
                               ("train_step", "train_step (ragged tail)"),
                               ("val_step", "val_step (ragged tail)")):
                setattr(trainer, attr, spanned(name, getattr(trainer, attr)))
        epoch = 2
        with profiled(run.trace) as traced:
            with torch.profiler.record_function(WINDOW):
                start, cpu = time.perf_counter(), time.process_time()
                deadline = start + run.seconds
                ends = []  # each epoch's end, seconds into the window
                while True:
                    window.begin()
                    trainer.train_epoch(epoch)
                    rows = trainer.last_step_losses
                    val, _ = trainer.val_epoch(epoch)
                    epochs += 1
                    steps += len(rows)
                    failed += int((~np.isfinite(rows[:, 0])).sum())
                    failed += int(not np.isfinite(val["total"]).all())
                    clouds += len(rows) * batch
                    flops += len(rows) * batch * train_flops + val_items * val_flops
                    capture_ms.append(sum(fn.capture_ms or 0.0 for fn in scans))
                    epoch += 1
                    now = time.perf_counter()
                    ends.append(now - start)
                    if now >= deadline or (limit is not None and epochs >= limit):
                        break
        window_s, cpu_s = now - start, time.process_time() - cpu
        peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
        observed.update(window.readings(epoch - 1))
        state = window.state
        del trainer, named, window
        gc.collect()
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
        want = follow(run, config, weights, state)
        gaps, why = compare(observed, want), detail(observed, want)
        other = {name: compare(follow(run, config, weights, state, q, r), want)
                 for name, q, r in variants}
    finally:
        shutil.rmtree(results, ignore_errors=True)
    return Outcome(
        attempted=steps, failed=failed,
        metrics={"setup_s": setup_s, "train_clouds_per_s": clouds / window_s},
        checks=[Check(k, v, p["limits"][k]) for k, v in gaps.items()],
        memory_peak_bytes=peak,
        counters={"kind": "train", "epochs": epochs, "steps": steps, "clouds": clouds,
                  "flops": flops, "batch": batch, "n_gt": n_gt, "n_partial": n_part,
                  "capture_ms": capture_ms, "window_s": window_s, "detail": why,
                  "variants": other, "notes": notes(window_s, cpu_s, ends)},
        trace=traced.summary)


def notes(window_s: float, cpu_s: float, ends: list) -> list[str]:
    """What shows where a run's rate came from (printed on stderr): each
    window epoch's seconds and the process's CPU seconds (every thread's)
    a second of the window."""
    epochs = " ".join(f"{b - a:.3f}" for a, b in zip([0.0, *ends], ends))
    return [f"window epoch seconds: {epochs}", f"window cpu s per s: {cpu_s / window_s:.4f}"]


def _first_epoch(trainer, named: dict, weights: dict) -> dict:
    """Epoch 1 (train, then val) through the Trainer, reading per leaf the
    first gradient (Adam's first moment after step 1) and the change after
    three steps, and the first three losses."""
    opt = trainer.optimizer
    b1 = opt.param_groups[0]["betas"][0]
    seen: dict = {}

    def hook(s):
        if s == 1:
            seen["grad1"] = {n: float(opt.state[q]["exp_avg"].norm()) / (1 - b1)
                             if q in opt.state else 0.0 for n, q in named.items()}
        elif s == STEPS_FOLLOWED:
            seen["delta3"] = {n: float((q.detach() - weights[n]).norm())
                              for n, q in named.items()}

    scan = trainer._epoch_scan_fn
    trainer._epoch_scan_fn = lambda ex, mi, gt, gens, *rest: scan(ex, mi, gt,
                                                                 _Watched(gens, hook), *rest)
    try:
        trainer.train_epoch(1)
    finally:
        trainer._epoch_scan_fn = scan
    if set(seen) != {"grad1", "delta3"}:
        raise RuntimeError(f"epoch 1 scanned fewer than {STEPS_FOLLOWED + 1} steps")
    seen["losses"] = [float(x) for x in trainer.last_step_losses[:STEPS_FOLLOWED, 0]]
    trainer.val_epoch(1)
    return seen


class _Window:
    """What the reference needs of the window's last epoch, kept on the card
    with no host sync: at each epoch's start the parameters and Adam's
    moments, after its first step the parameters and first moment, and the
    losses of its val steps. Buffers are made once, in set-up."""

    def __init__(self, trainer, named: dict):
        self.trainer, self.named = trainer, named
        opt = trainer.optimizer
        self.b1 = opt.param_groups[0]["betas"][0]
        held = {n: opt.state[q] for n, q in named.items() if q in opt.state}
        self.src = {"p": {n: q.detach() for n, q in named.items()},
                    "m": {n: s["exp_avg"] for n, s in held.items()},
                    "v": {n: s["exp_avg_sq"] for n, s in held.items()}}
        self.begun = {k: {n: torch.empty_like(t) for n, t in d.items()}
                      for k, d in self.src.items()}
        self.first = {k: {n: torch.empty_like(t) for n, t in self.src[k].items()}
                      for k in ("p", "m")}
        self.val_losses: list = []

        train_scan, val_scan, val_step = (trainer._epoch_scan_fn, trainer._val_epoch_scan_fn,
                                          trainer.val_step)

        def hook(s):
            if s == 1:
                self._copy(self.first)

        def scanned_val(*args, **kwargs):
            losses, rec = val_scan(*args, **kwargs)
            self.val_losses.append(losses.reshape(-1))
            return losses, rec

        def stepped_val(*args, **kwargs):
            loss, rec = val_step(*args, **kwargs)
            self.val_losses.append(loss.reshape(-1))
            return loss, rec

        trainer._epoch_scan_fn = lambda ex, mi, gt, gens, *rest: train_scan(
            ex, mi, gt, _Watched(gens, hook), *rest)
        trainer._val_epoch_scan_fn, trainer.val_step = scanned_val, stepped_val

    @torch.no_grad()
    def _copy(self, into: dict) -> None:
        for k, d in into.items():
            for n, t in d.items():
                t.copy_(self.src[k][n])

    def begin(self) -> None:
        """Before each window epoch."""
        self._copy(self.begun)
        self.val_losses = []

    @torch.no_grad()
    def readings(self, epoch: int) -> dict:
        """The program's readings of the last epoch ``epoch``, and in
        ``self.state`` its state for the reference (the parameters and
        moments as the epoch began, the parameters it ended with)."""
        b, f = self.begun, self.first
        grad = {n: float(((f["m"][n] - self.b1 * b["m"][n]) / (1 - self.b1)).norm())
                if n in f["m"] else 0.0 for n in self.named}
        out = {"wloss1": float(self.trainer.last_step_losses[0, 0]), "wgrad1": grad,
               "wstep1": {n: float((f["p"][n] - b["p"][n]).norm()) for n in self.named},
               "val": [float(x) for x in torch.cat(self.val_losses).cpu()]}
        self.state = {"epoch": epoch, "params": b["p"], "m": b["m"], "v": b["v"],
                      "end": {n: q.detach().clone() for n, q in self.named.items()}}
        self.first = self.src = None
        self.trainer = None
        return out


# ---------------------------------------------------------------------------
# The reference, from the configuration alone


def _batches(loader: dict, seed: int, n_items: int, epoch: int) -> list[np.ndarray]:
    """A loader's batches of an epoch: the items shuffled (``shuffle``) by a
    generator keyed on (seed, epoch), the last short batch kept unless
    ``drop_last``."""
    order = np.arange(n_items)
    if loader["shuffle"]:
        np.random.default_rng((seed, epoch)).shuffle(order)
    size = int(loader["batch_size"])
    out = [order[i:i + size] for i in range(0, n_items, size)]
    if loader["drop_last"] and out and len(out[-1]) < size:
        out.pop()
    return out


def _learning_rate(config: dict, epoch: int) -> float:
    tr = config["training"]
    lr = float(tr["optimizer"]["hyperparams"]["lr"])
    sched = tr.get("lr_scheduler")
    if not sched:
        return lr
    if sched["type"] != "StepLR":
        raise ValueError(f"the reference knows StepLR, not {sched['type']}")
    hp = sched["hyperparams"]
    return lr * float(hp.get("gamma", 0.1)) ** ((epoch - 1) // int(hp["step_size"]))


class _Plan:
    """The corpus, an epoch's train and val batches and each step's
    generator, as the configuration makes them: the step counter
    ``seed * 1_000_003`` goes up by one a step, train and val alike."""

    def __init__(self, run, config: dict):
        p = run.params["corpus"]
        self.samples, self.n_gt = p["samples"], p["n_gt"]
        self.gt, self.ex, self.mi = inputs.corpus_arrays(p["shapes"], p["samples"], p["n_gt"],
                                                         p["n_partial"], p["corpus_seed"])
        self.config, self.seed = config, int(config["setup"]["seed"])
        self.n_items = self.gt.shape[0] * self.samples
        self.loaders = config["training"]["dataloader"]

    def epoch(self, epoch: int) -> tuple[list, list, int]:
        """(train batches, val batches, the counter before the epoch)."""
        train = _batches(dict({"shuffle": True, "drop_last": True}, **self.loaders["train"]),
                         self.seed, self.n_items, epoch)
        val = _batches(dict({"shuffle": False, "drop_last": False}, **self.loaders["val"]),
                       self.seed + 1, self.n_items, epoch)
        return train, val, self.seed * 1_000_003 + (epoch - 1) * (len(train) + len(val))

    def step(self, idx: np.ndarray, counter: int, epoch: int, device):
        """(existing, missing, gt, vae eps, ball points) of one step."""
        model = self.config["full_model"]
        shape, scan = idx // self.samples, idx % self.samples
        g = torch.Generator(device=device).manual_seed(counter & 0xFFFFFFFF)
        zdim = int(model["random_encoder"]["output_size"])
        eps = torch.randn((len(idx), zdim), generator=g, device=device) if zdim > 0 else None
        balls = ref.ball_points(g, len(idx), self.n_gt, float(epoch),
                                model["target_network_input"])

        def dev(a):
            return torch.as_tensor(a, device=device)

        return dev(self.ex[shape, scan]), dev(self.mi[shape, scan]), dev(self.gt[shape]), eps, balls


def _train_step(plan, params, idx, counter, epoch, q, rows):
    """(loss, gradients) of one reference train step."""
    config = plan.config
    device = next(iter(params.values())).device
    ex, mi, gt, eps, balls = plan.step(idx, counter, epoch, device)
    loss, _, _ = ref.train_loss(params, config["full_model"], ex, mi, gt, eps, balls,
                                float(config["training"]["loss_coef"]), q, rows)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return float(loss.detach()), {n: torch.zeros_like(v) if g is None else g
                                  for (n, v), g in zip(params.items(), grads)}


def _adam(config: dict, params: dict, epoch: int, state=None):
    hp = config["training"]["optimizer"]["hyperparams"]
    return ref.Adam(params, _learning_rate(config, epoch), tuple(hp["betas"]),
                    float(hp.get("eps", 1e-8)), state)


def follow(run, config: dict, weights: dict, state: dict | None = None, q=None,
           rows: slice | None = None) -> dict:
    """The reference's readings, as the program's are read: epoch 1's first
    three steps from ``weights``, and, given ``state``, the last window
    epoch's first step and val steps. ``q`` and ``rows`` make the controls
    and faults (``reference.model``)."""
    plan = _Plan(run, config)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    adam = _adam(config, params, 1)
    train, _, counter = plan.epoch(1)
    out = {"losses": []}
    with ref.fp32_highest():
        for k, idx in enumerate(train[:STEPS_FOLLOWED]):
            loss, grads = _train_step(plan, params, idx, counter + k + 1, 1, q, rows)
            if k == 0:
                out["grad1"] = {n: float(g.norm()) for n, g in grads.items()}
            adam.step(params, grads)
            out["losses"].append(loss)
        out["delta3"] = {n: float((v.detach() - weights[n]).norm()) for n, v in params.items()}
        if state is not None:
            out.update(_follow_window(plan, state, q, rows))
    return out


def _follow_window(plan, state: dict, q, rows) -> dict:
    """The last window epoch's first step from the program's parameters and
    moments as it began (Adam's count: every earlier epoch's steps), and its
    val losses from the parameters it ended with."""
    epoch = state["epoch"]
    train, val, counter = plan.epoch(epoch)
    start = state["params"]
    params = {n: v.clone().requires_grad_(True) for n, v in start.items()}
    moments = ({n: state["m"].get(n, torch.zeros_like(v)).clone() for n, v in start.items()},
               {n: state["v"].get(n, torch.zeros_like(v)).clone() for n, v in start.items()},
               (epoch - 1) * len(train))
    adam = _adam(plan.config, params, epoch, moments)
    loss, grads = _train_step(plan, params, train[0], counter + 1, epoch, q, rows)
    adam.step(params, grads)
    out = {"wloss1": loss, "wgrad1": {n: float(g.norm()) for n, g in grads.items()},
           "wstep1": {n: float((params[n].detach() - start[n]).norm()) for n in start},
           "val": []}
    model, coef = plan.config["full_model"], float(plan.config["training"]["loss_coef"])
    counter += len(train)
    device = next(iter(start.values())).device
    with torch.no_grad():
        for j, idx in enumerate(val):
            ex, mi, gt, _, balls = plan.step(idx, counter + j + 1, epoch, device)
            out["val"].append(float(ref.val_loss(state["end"], model, ex, mi, gt, balls, coef,
                                                 q, rows)))
    return out


def reference_inputs(run) -> tuple[dict, dict]:
    """(weights, settings) of a run as the reference takes them, with no
    program: the weights the run makes and its configuration."""
    config = settings(run, "unused", "unused")
    return inputs.make_weights(config["full_model"], run.sub_seed("weights"), run.device), config


def _leaf_gaps(got: dict, want: dict, leaves) -> dict:
    floor = statistics.median(want[n] for n in leaves)
    return {n: abs(got[n] - want[n]) / max(want[n], floor, 1e-30) for n in leaves}


def _moved(grad: dict) -> list:
    leaves = sorted(grad)
    median = statistics.median(grad[n] for n in leaves)
    return [n for n in leaves if grad[n] >= DEAD_LEAF * median]


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def _steps_gap(got: list, want: list) -> float:
    if len(got) != len(want):
        return float("inf")
    return max(_rel(a, b) for a, b in zip(got, want))


def compare(got: dict, want: dict) -> dict:
    """The compared numbers of a run (see the module docstring)."""
    gaps = {"loss1_gap": _rel(got["losses"][0], want["losses"][0]),
            "grad1_gap": max(_leaf_gaps(got["grad1"], want["grad1"], sorted(want["grad1"]))
                             .values()),
            "delta3_gap": max(_leaf_gaps(got["delta3"], want["delta3"], _moved(want["grad1"]))
                              .values())}
    if "wloss1" in want:
        gaps.update(
            wloss1_gap=_rel(got["wloss1"], want["wloss1"]),
            wgrad1_gap=max(_leaf_gaps(got["wgrad1"], want["wgrad1"], sorted(want["wgrad1"]))
                           .values()),
            wstep1_gap=max(_leaf_gaps(got["wstep1"], want["wstep1"], _moved(want["wgrad1"]))
                           .values()),
            val_gap=_steps_gap(got["val"], want["val"]))
    return gaps


def detail(got: dict, want: dict) -> dict:
    """What lies behind the compared numbers: every step's loss gap, and the
    leaves that read the widest gaps."""
    def worst(key, leaves):
        gaps = _leaf_gaps(got[key], want[key], leaves)
        return sorted(gaps.items(), key=lambda kv: -kv[1])[:3]

    out = {"loss_gaps": [_rel(a, b) for a, b in zip(got["losses"], want["losses"])],
           "grad1_worst": worst("grad1", sorted(want["grad1"])),
           "delta3_worst": worst("delta3", _moved(want["grad1"])),
           "left_out": sorted(set(want["grad1"]) - set(_moved(want["grad1"])))}
    if "wloss1" in want:
        val = [_rel(a, b) for a, b in zip(got["val"], want["val"])]
        out.update(wgrad1_worst=worst("wgrad1", sorted(want["wgrad1"])),
                   wstep1_worst=worst("wstep1", _moved(want["wgrad1"])),
                   val_steps=len(want["val"]),
                   val_gap_median=statistics.median(val) if val else None)
    return out
