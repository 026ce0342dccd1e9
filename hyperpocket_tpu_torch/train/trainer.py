"""The train and val steps and the epoch loops.

Port of ``hyperpocket_tpu/train/trainer.py``:

* ``make_train_step`` / ``make_val_step``: one forward with autograd, the
  Chamfer + KLD loss, one backward and one optimizer update, eagerly on the
  model's device; the val step is the inference forward and the loss.
  Randomness comes from an explicit ``torch.Generator``; the
  ``vae_eps``/``ball_points`` hooks replace the two draws with given values.
* ``make_fused_train_step``: the step with the hypernetwork head's weight
  updated by the fused head-Adam kernel K11 (``ops/head_adam.py``) instead
  of the optimizer. As in the JAX package it is not wired to ``Trainer``.
* ``Trainer``: the session a training config describes: the results tree
  and logging, the model, optimizer and schedule, the loaders, the epoch
  loops, checkpoints in the JAX package's layout (``train/checkpoint.py``)
  and resume, exact to the draws: every step seeds a
  ``torch.Generator`` from the counter ``seed * 1_000_003 + n``, and the
  counter is saved with each checkpoint.

Parallel training (``training.parallel``, ``parallel/mesh.py``): one
process per device over a ``(data, model)`` mesh, as the JAX package's
defaults choose it: ``data: null`` is the whole world over ``model``, and
the mesh is used when ``data x model > 1`` and the batch divides over the
data axis (``use_mesh=True`` forces it, at any world size). Each rank loads
its rows of every batch (``BatchLoader(process_shard=)``), draws the
*global* batch's VAE noise and ball points from the shared step counter and
keeps its rows, so a data-parallel step is the one-process step on the
same batch. The loss is a sum over the batch and the KLD divides by the
global batch, so each rank's gradients are partial sums: they are summed
(not averaged) over the data axis, and the losses returned are the global
ones. With ``model > 1`` the hypernetwork's ``trunk[-1]`` and head are
tensor-parallel. Rank 0 alone writes logs, samples and checkpoints; the
checkpoint holds the full tensors (``mesh.unsharded``), so it is the
one-process file, and a restore re-shards it.

``training.epoch_mode: "scan"`` (``make_train_epoch_scan``,
``make_val_epoch_scan``; the machinery is ``train/epoch_scan.py``): the
uniform batch prefix of each train epoch and of each val category runs as
one stacked upload and, on a card, replays of one CUDA graph of the step,
captured anew each epoch; ragged tail batches run the step function, and
every step takes its own value of the step counter, so the trajectory is
the step loop's. On the CPU the same epoch function runs the step eagerly.
As in the JAX package, ``injection_provider`` runs the step loop, an epoch
of fewer than two uniform batches is not scanned, and ``scan_invocations``
and ``val_scan_invocations`` count the scanned epochs and categories.

Not ported: the compile cache (``setup.compile_cache``) and
``training.prng_impl``, which are not read.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass
from os import makedirs
from os.path import exists, join
from typing import Any, Callable

import numpy as np
import torch

from hyperpocket_tpu_torch.models.full_model import _DTYPES, FullModel
from hyperpocket_tpu_torch.ops.head_adam import adam_scalars, head_adam_update
from hyperpocket_tpu_torch.ops.nn import chamfer_loss_auto
from hyperpocket_tpu_torch.parallel import distributed
from hyperpocket_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    all_reduce_,
    all_reduce_grads,
    batch_rows,
    make_mesh,
    replicate,
    shard_params,
    unsharded,
)
from hyperpocket_tpu_torch.train import checkpoint as ckpt
from hyperpocket_tpu_torch.train.config import get_results_dir_path
from hyperpocket_tpu_torch.train.epoch_scan import EpochScan, upload_stacked
from hyperpocket_tpu_torch.train.losses import kld_loss, reconstruction_loss
from hyperpocket_tpu_torch.train.optim import (
    make_lr_schedule,
    make_optimizer,
    set_learning_rate,
    trainable_parameters,
)


def model_from_config(config: dict[str, Any],
                      generator: torch.Generator | None = None) -> FullModel:
    """The model as the Trainer builds it: ``full_model.compute_dtype``
    defaults to ``training.compute_dtype``."""
    fm_cfg = dict(config["full_model"])
    fm_cfg.setdefault("compute_dtype", config.get("training", {}).get("compute_dtype", "float32"))
    return FullModel.from_config(fm_cfg, generator)


def set_matmul_precision(precision: str = "highest") -> None:
    """``training.matmul_precision``: "highest" turns TF32 off for fp32
    matmuls and cuDNN; any other value allows it."""
    tf32 = precision != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


def _losses(model: FullModel, rec, mu, sigma, gt, loss_coef: float, batch: int):
    """(loss, loss_r, loss_k); the KLD divides by ``batch``, the global batch."""
    loss_r = reconstruction_loss(gt, rec, loss_coef)
    if model.has_generativity:
        loss_k = kld_loss(mu, sigma, batch)
    else:
        loss_k = torch.zeros((), dtype=loss_r.dtype, device=loss_r.device)
    return loss_r + loss_k, loss_r, loss_k


def _local_draws(mesh: Mesh, model: FullModel, generator, batch: int, num_points: int, epoch,
                 vae_eps, ball_points, device):
    """This rank's rows of the global batch's draws."""
    vae_eps, ball_points = model.random_inputs(generator, batch, num_points, epoch, vae_eps,
                                               ball_points)
    rows = batch_rows(mesh, batch)
    return (None if vae_eps is None else torch.as_tensor(vae_eps)[rows].to(device),
            torch.as_tensor(ball_points)[rows].to(device))


def make_train_step(model: FullModel, optimizer: torch.optim.Optimizer,
                    loss_coef: float, mesh: Mesh | None = None) -> Callable:
    """Returns ``step(existing, missing, gt, generator, epoch, num_points,
    vae_eps=None, ball_points=None) -> (loss, loss_r, loss_k, rec)``.

    The step updates ``model``'s parameters in place through ``optimizer``.
    The returned tensors are detached.

    With ``mesh`` the clouds are this rank's rows of the global batch and
    ``vae_eps``/``ball_points``, when given, the global batch's; the missing
    draws are made for the global batch and cut to this rank's rows. The
    gradients are summed over the data axis before the update, and the
    losses returned are the global sums; ``rec`` is this rank's rows.
    """
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(existing, missing, gt, generator, epoch, num_points, vae_eps=None,
             ball_points=None):
        optimizer.zero_grad(set_to_none=True)
        batch = existing.shape[0]
        if mesh is not None:
            batch *= mesh.size(DATA_AXIS)
            vae_eps, ball_points = _local_draws(mesh, model, generator, batch, num_points,
                                                epoch, vae_eps, ball_points, existing.device)
        rec, mu, sigma = model.apply(existing, missing, generator, epoch,
                                     num_output_points=num_points, training=True,
                                     vae_eps=vae_eps, ball_points=ball_points)
        loss, loss_r, loss_k = _losses(model, rec, mu, sigma, gt, loss_coef, batch)
        loss.backward()
        if mesh is None:
            optimizer.step()
            return loss.detach(), loss_r.detach(), loss_k.detach(), rec.detach()
        all_reduce_grads(params, mesh.group(DATA_AXIS))
        optimizer.step()
        losses = all_reduce_(torch.stack([loss, loss_r, loss_k]).detach(),
                             mesh.group(DATA_AXIS))
        return (*losses.unbind(), rec.detach())

    return step


def init_head_adam_state(model: FullModel, moment_dtype: str = "bfloat16") -> dict:
    """Adam state of the head weight for ``make_fused_train_step``: zero
    moments in ``moment_dtype`` and ``count`` 0."""
    w = model.hyper_network.heads.weight
    md = _DTYPES[moment_dtype]
    return {"m": torch.zeros(w.shape, dtype=md, device=w.device),
            "v": torch.zeros(w.shape, dtype=md, device=w.device), "count": 0}


def make_fused_train_step(model: FullModel, optimizer: torch.optim.Optimizer, loss_coef: float,
                          adam_cfg: tuple = (0.9, 0.999, 1e-8)) -> Callable:
    """The train step with the head weight updated by the fused head-Adam kernel.

    Returns ``step(head_state, existing, missing, gt, generator, epoch,
    num_points, vae_eps=None, ball_points=None) -> (loss, loss_r, loss_k,
    rec)``. The forward runs with the head taps (``FullModel.apply``'s
    ``head_delta`` and ``return_trunk``): autograd forms no head-weight
    gradient, the zero ``head_delta``'s gradient is the head output's
    cotangent, and after ``optimizer.step()`` ``head_adam_update`` (K11 on
    a CUDA tensor) forms dW from it and the trunk activations and applies
    Adam to the weight and ``head_state``'s moments in place, with the
    optimizer's learning rate and ``head_state["count"]`` incremented
    first. ``optimizer`` must leave the head weight out; plain Adam
    (weight decay 0), as in the JAX package.
    """
    b1, b2, eps = adam_cfg
    w = model.hyper_network.heads.weight
    if any(p is w for group in optimizer.param_groups for p in group["params"]):
        raise ValueError("the fused step updates the head weight itself: leave it out of "
                         "the optimizer")

    def step(head_state, existing, missing, gt, generator, epoch, num_points, vae_eps=None,
             ball_points=None):
        optimizer.zero_grad(set_to_none=True)
        delta = torch.zeros((existing.shape[0], w.shape[0]), dtype=model.compute_torch_dtype,
                            device=existing.device, requires_grad=True)
        rec, mu, sigma, h = model.apply(existing, missing, generator, epoch,
                                        num_output_points=num_points, training=True,
                                        vae_eps=vae_eps, ball_points=ball_points,
                                        head_delta=delta, return_trunk=True)
        loss, loss_r, loss_k = _losses(model, rec, mu, sigma, gt, loss_coef, gt.shape[0])
        loss.backward()
        optimizer.step()
        head_state["count"] += 1
        scalars = adam_scalars(optimizer.param_groups[0]["lr"], b1, b2, eps,
                               head_state["count"])
        head_adam_update(h.detach(), delta.grad, w.detach(), head_state["m"], head_state["v"],
                         scalars)
        return loss.detach(), loss_r.detach(), loss_k.detach(), rec.detach()

    return step


def make_val_step(model: FullModel, loss_coef: float, mesh: Mesh | None = None) -> Callable:
    """Returns ``step(existing, missing, gt, generator, epoch, num_points,
    vae_eps=None, ball_points=None) -> (loss, rec)``: the inference forward
    and the reconstruction loss, with no gradient. ``vae_eps`` and
    ``ball_points`` (the global batch's) replace the two draws.

    With ``mesh`` the clouds are the global batch. When it divides over the
    data axis, each rank runs its rows, with its rows of the global draws,
    and the loss is summed over the data axis; ``rec`` is then this rank's
    rows. Otherwise every rank runs the whole batch, as JAX leaves an
    indivisible batch unsharded.
    """

    @torch.no_grad()
    def step(existing, missing, gt, generator, epoch, num_points, vae_eps=None,
             ball_points=None):
        batch = existing.shape[0]
        if mesh is None or batch % mesh.size(DATA_AXIS):
            rec = model.apply(existing, missing, generator, epoch,
                              num_output_points=num_points, training=False, vae_eps=vae_eps,
                              ball_points=ball_points)
            return reconstruction_loss(gt, rec, loss_coef), rec
        vae_eps, balls = _local_draws(mesh, model, generator, batch, num_points, epoch,
                                      vae_eps, ball_points, existing.device)
        rows = batch_rows(mesh, batch)
        rec = model.apply(existing[rows], None if missing is None else missing[rows],
                          generator, epoch, num_output_points=num_points, training=False,
                          vae_eps=vae_eps, ball_points=balls)
        loss = reconstruction_loss(gt[rows], rec, loss_coef)
        return all_reduce_(loss, mesh.group(DATA_AXIS)), rec

    return step


def make_train_epoch_scan(model: FullModel, optimizer: torch.optim.Optimizer,
                          loss_coef: float, mesh: Mesh | None = None) -> EpochScan:
    """The train step over an epoch's stacked batches (``epoch_mode: "scan"``).

    Returns ``epoch_fn(existing, missing, gt, generators, epoch, num_points)
    -> (losses (S, 3), rec)``: the clouds stacked (S, B, ...) on the device,
    one seeded generator a step (the step loop's counter values), the
    per-step (loss, loss_r, loss_kld) rows and the last step's
    reconstruction. The body is ``make_train_step``'s step on the static
    buffers with the step's draws given, so the trajectory is the step
    loop's; on a card it is a CUDA graph captured each call and replayed a
    step (``train/epoch_scan.py``). Under ``mesh`` each rank draws the
    global batch, as the step does.
    """
    step = make_train_step(model, optimizer, loss_coef, mesh)

    def body(existing, missing, gt, epoch, num_points, vae_eps, ball_points):
        loss, loss_r, loss_k, rec = step(existing, missing, gt, None, epoch, num_points,
                                         vae_eps=vae_eps, ball_points=ball_points)
        return torch.stack([loss, loss_r, loss_k]), rec

    return EpochScan(body, model=model, optimizer=optimizer, name="train",
                     draw_rows=1 if mesh is None else mesh.size(DATA_AXIS))


def make_val_epoch_scan(model: FullModel, loss_coef: float,
                        mesh: Mesh | None = None) -> EpochScan:
    """The val step over a category's stacked batches: ``epoch_fn(existing,
    missing, gt, generators, epoch, num_points) -> (losses (S,), rec)``, as
    ``make_train_epoch_scan`` with ``make_val_step``'s step as the body."""
    step = make_val_step(model, loss_coef, mesh)

    def body(existing, missing, gt, epoch, num_points, vae_eps, ball_points):
        return step(existing, missing, gt, None, epoch, num_points, vae_eps=vae_eps,
                    ball_points=ball_points)

    return EpochScan(body, model=model, name="val")


def _uniform_prefix(batches: list) -> int:
    """How many batches from the first on have the first one's shapes."""
    def shapes(b):
        return tuple(None if a is None else a.shape for a in b)

    lead, n = shapes(batches[0]), 0
    while n < len(batches) and shapes(batches[n]) == lead:
        n += 1
    return n


@dataclass
class EpochStats:
    loss_all: float
    loss_r: float
    loss_kld: float


class Trainer:
    """A training session built from a reference-schema config.

    ``device`` defaults to ``cuda`` and raises when CUDA is absent. The
    deterministic-injection hook ``injection_provider`` is a callable
    ``(epoch, batch_index) -> {"vae_eps": ..., "ball_points": ...}`` whose
    arrays replace a train step's draws; after each ``train_epoch``
    ``last_step_losses`` holds that epoch's per-step (loss, loss_r,
    loss_kld) rows.

    ``use_mesh`` as in the JAX package: None decides from
    ``training.parallel`` and the world size (see the module docstring),
    True forces the mesh. Under a process group a ``cuda`` device means
    this rank's card.
    """

    def __init__(self, config: dict, *, device: str | torch.device = "cuda",
                 use_mesh: bool | None = None):
        from hyperpocket_tpu_torch.data.base import get_datasets
        from hyperpocket_tpu_torch.data.loader import BatchLoader
        from hyperpocket_tpu_torch.utils.logging_setup import logging_setup, seed_setup

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is not available")
        if distributed.is_initialized():
            self.device = distributed.rank_device(self.device)
        self.config = config
        tr = config["training"]
        dl_cfg = tr.get("dataloader", {})
        tcfg = dict(dl_cfg.get("train", {"batch_size": 8}))
        vcfg = dict(dl_cfg.get("val", {"batch_size": 8}))
        self.mesh = self._make_mesh(tr.get("parallel", {}), int(tcfg.get("batch_size", 8)),
                                    use_mesh)
        self.is_writer = distributed.is_main_process()
        seed = int(config["setup"]["seed"])
        seed_setup(seed)
        set_matmul_precision(tr.get("matmul_precision", "highest"))
        self._seed_counter = seed * 1_000_003

        self.result_dir = get_results_dir_path(config, "training")
        self.weights_path = join(self.result_dir, "weights")
        self.metrics_path = join(self.result_dir, "metrics")
        self.samples_path = join(self.result_dir, "samples")
        if self.is_writer:
            for d in (self.result_dir, self.weights_path, self.metrics_path,
                      self.samples_path):
                makedirs(d, exist_ok=True)
            with open(join(self.result_dir, "last_config.json"), "w") as fh:
                json.dump(config, fh)
            logging_setup(self.result_dir)
        self.log = logging.getLogger("hyperpocket_tpu_torch")

        # training.param_dtype = "float64" is the trajectory-parity mode (CPU)
        self.model = model_from_config(config, torch.Generator().manual_seed(seed)).to(
            device=self.device, dtype=_DTYPES[tr.get("param_dtype", "float32")])
        if self.mesh is not None:
            replicate(self.mesh, self.model)
            shard_params(self.mesh, self.model)
            self.log.info("mesh: data=%d model=%d", self.mesh.size("data"),
                          self.mesh.size("model"))
        self.loss_coef = float(tr.get("loss_coef", 0.05))
        self.max_epoch = int(tr["max_epoch"])
        self.save_freq = int(tr.get("state_save_frequency", 1))
        self.min_save_epoch = int(tr.get("min_save_epoch", 0))
        self.optimizer = make_optimizer(tr["optimizer"], trainable_parameters(self.model))
        base_lr = float(tr["optimizer"].get("hyperparams", {}).get("lr", 1e-3))
        self.lr_schedule = make_lr_schedule(tr.get("lr_scheduler"), base_lr)
        self.updates = 0  # optimizer updates made: the optax state's count

        self.train_dataset, self.val_dataset_dict, self.test_dataset_dict = get_datasets(
            config["dataset"])
        shard = ((0, 1) if self.mesh is None
                 else (self.mesh.index(DATA_AXIS), self.mesh.size(DATA_AXIS)))
        self.train_loader = BatchLoader(
            self.train_dataset, tcfg.get("batch_size", 8), shuffle=tcfg.get("shuffle", True),
            drop_last=tcfg.get("drop_last", True), num_workers=tcfg.get("num_workers", 8),
            seed=seed, process_shard=shard)
        for cat, ds in self.val_dataset_dict.items():
            if len(ds) == 0:
                self.log.info("val category %s: no items in split, skipped", cat)
        self.val_loaders = {
            cat: BatchLoader(ds, vcfg.get("batch_size", 8), shuffle=vcfg.get("shuffle", False),
                             drop_last=vcfg.get("drop_last", False),
                             num_workers=vcfg.get("num_workers", 8), seed=seed + 1)
            for cat, ds in self.val_dataset_dict.items() if len(ds) > 0
        }
        self.profile_cfg = tr.get("profile", {})
        ckpt_cfg = tr.get("checkpoint", {})
        self._async_ckpt = (ckpt.AsyncCheckpointer(bool(ckpt_cfg.get("drop_if_busy", True)))
                            if ckpt_cfg.get("async", False) else None)

        # training.compute_dtype_switch = {"epoch": N, "compute_dtype": "float32"}:
        # epochs <= N run training.compute_dtype, later ones the switch dtype;
        # parameters and optimizer state are the fp32 masters either way
        sw = tr.get("compute_dtype_switch")
        self._dtype_switch = (int(sw["epoch"]), str(sw.get("compute_dtype", "float32"))) if sw else None
        self.train_step = make_train_step(self.model, self.optimizer, self.loss_coef, self.mesh)
        self.val_step = make_val_step(self.model, self.loss_coef, self.mesh)
        self.uses_missing = self.model.mode != "hyper_rec"
        self.epoch_mode = str(tr.get("epoch_mode", "step"))
        if self.epoch_mode not in ("step", "scan"):
            raise ValueError(f"training.epoch_mode must be 'step' or 'scan', got {self.epoch_mode!r}")
        scan = self.epoch_mode == "scan"
        self._epoch_scan_fn = (make_train_epoch_scan(self.model, self.optimizer, self.loss_coef,
                                                     self.mesh) if scan else None)
        self._val_epoch_scan_fn = (make_val_epoch_scan(self.model, self.loss_coef, self.mesh)
                                   if scan else None)
        if scan:
            self.log.info("epoch_mode 'scan': each epoch's uniform batch prefix runs %s",
                          "as replays of a CUDA graph" if self.device.type == "cuda"
                          else "stacked, the step eagerly on the CPU")
        # the scanned train epochs and val categories (n_scan > 1) run so far
        self.scan_invocations = 0
        self.val_scan_invocations = 0
        self._chamfer_route_logged = False

        self.train_losses: list = []
        self.val_losses: list = []
        self.best_epoch_loss = np.inf
        self.start_epoch = 1
        self.injection_provider = None
        self.last_step_losses: np.ndarray | None = None
        self._maybe_restore()

    # ------------------------------------------------------------------
    @staticmethod
    def _make_mesh(par: dict, batch_size: int, use_mesh: bool | None) -> Mesh | None:
        """The (data, model) mesh ``training.parallel`` asks for, as the JAX
        Trainer chooses it, or None for one-process training."""
        world = distributed.world_size()
        n_model = int(par.get("model", 1))
        if world % n_model:
            raise ValueError(f"parallel.model={n_model} does not divide {world} devices")
        n_data = int(par.get("data") or world // n_model)
        if use_mesh is None:
            use_mesh = n_data * n_model > 1 and batch_size % n_data == 0
        if not use_mesh:
            if world > 1:
                raise ValueError(f"{world} ranks but no mesh: training.parallel={par} with "
                                 f"batch_size {batch_size} does not split over them")
            return None
        return make_mesh(n_data, n_model)

    def _next_generator(self) -> torch.Generator:
        """A generator on the device, seeded from the next value of the step counter."""
        self._seed_counter += 1
        return torch.Generator(device=self.device).manual_seed(self._seed_counter & 0xFFFFFFFF)

    def _maybe_restore(self) -> None:
        latest = ckpt.find_latest_resumable_epoch(self.weights_path, self.metrics_path)
        if latest <= 0:
            return
        with unsharded(self.mesh, self.model, self.optimizer):
            epoch, self.updates = ckpt.restore_model_state(
                self.weights_path, self.metrics_path, latest, "latest", self.model,
                self.optimizer)
        self.train_losses, self.val_losses, self.best_epoch_loss = ckpt.restore_metrics(
            self.metrics_path, epoch)
        s_path = join(self.weights_path, f"{epoch:05}_S.json")
        if exists(s_path):
            with open(s_path) as fh:
                sched_state = json.load(fh)
            if "seed_counter" in sched_state:
                self._seed_counter = int(sched_state["seed_counter"])
        self.start_epoch = epoch + 1
        self.log.info("restored epoch %d", epoch)

    def _maybe_switch_dtype(self, epoch: int) -> None:
        """Cross the ``compute_dtype_switch`` boundary once (a resumed run
        crosses it the same way, since ``run`` checks every epoch)."""
        if self._dtype_switch is None:
            return
        sw_epoch, sw_dtype = self._dtype_switch
        if epoch <= sw_epoch or self.model.compute_dtype == sw_dtype:
            return
        self.model.compute_dtype = sw_dtype
        self.log.info("compute_dtype switched to %s at epoch %d", sw_dtype, epoch)

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def _prep_missing(self, missing):
        """HyperRec and scalar placeholders (Completion3D) drop missing."""
        if not self.uses_missing or not isinstance(missing, np.ndarray) or missing.ndim != 3:
            return None
        return missing

    def _batch(self, existing, missing, gt):
        """One loader batch on the device."""
        missing = self._prep_missing(missing)
        return (self._to_device(existing), None if missing is None else self._to_device(missing),
                self._to_device(gt))

    def _collect(self, loader, epoch: int) -> tuple[list, list]:
        """A scanned epoch's batches (missing prepared) and their generators,
        one counter value each, in the step loop's order."""
        batches, generators = [], []
        for existing, missing, gt, _ in loader.epoch(epoch):
            batches.append((existing, self._prep_missing(missing), gt))
            generators.append(self._next_generator())
        return batches, generators

    def _stacked(self, batches: list) -> tuple:
        """Batches stacked (S, B, ...) on the device in one upload."""
        use_missing = batches[0][1] is not None
        cols = [0, 1, 2] if use_missing else [0, 2]
        dev = upload_stacked([[b[i] for b in batches] for i in cols], self.device)
        return dev[0], dev[1] if use_missing else None, dev[-1]

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int) -> tuple[EpochStats, tuple | None]:
        """One epoch of train steps; the stats are the true means over its steps."""
        set_learning_rate(self.optimizer, self.lr_schedule(epoch))
        if self._epoch_scan_fn is not None and self.injection_provider is None:
            return self._train_epoch_scan(epoch)
        rows, latest = [], None
        for existing, missing, gt, _ in self.train_loader.epoch(epoch):
            ex, mi, g = self._batch(existing, missing, gt)
            inject = {}
            if self.injection_provider is not None:
                inject = {k: self._to_device(v)
                          for k, v in self.injection_provider(epoch, len(rows)).items()}
            loss, loss_r, loss_k, rec = self.train_step(
                ex, mi, g, self._next_generator(), float(epoch), int(gt.shape[1]), **inject)
            self.updates += 1
            rows.append(torch.stack([loss, loss_r, loss_k]))
            latest = (existing, gt, rec)
            self._log_chamfer_route()
        # one device fetch per epoch
        self.last_step_losses = (torch.stack(rows).cpu().numpy() if rows else np.zeros((0, 3)))
        sums = self.last_step_losses.sum(axis=0) if rows else np.zeros(3)
        if latest is not None:
            latest = (latest[0], latest[1], latest[2].float().cpu().numpy())
        return EpochStats(*(sums / max(len(rows), 1))), latest

    def _log_chamfer_route(self) -> None:
        """Log, once per Trainer, the Chamfer route its train steps took
        (``ops/nn.py::chamfer_grad_route``: "k9", "streaming" or "plain")."""
        if not self._chamfer_route_logged and chamfer_loss_auto.route is not None:
            self.log.info("training loss: Chamfer route %r (deterministic algorithms %s)",
                          chamfer_loss_auto.route, torch.are_deterministic_algorithms_enabled())
            self._chamfer_route_logged = True

    def _train_epoch_scan(self, epoch: int) -> tuple[EpochStats, tuple | None]:
        """The epoch's batches collected, the uniform prefix through one
        scanned call, ragged tail batches through the step function, each
        with its own counter value: the step loop's trajectory."""
        batches, generators = self._collect(self.train_loader, epoch)
        if not batches:
            self.last_step_losses = np.zeros((0, 3))
            return EpochStats(0.0, 0.0, 0.0), None
        n_scan = _uniform_prefix(batches)
        rows, rec, start = [], None, 0
        if n_scan > 1:
            losses, rec = self._epoch_scan_fn(*self._stacked(batches[:n_scan]),
                                              generators[:n_scan], float(epoch),
                                              int(batches[0][2].shape[1]))
            self.scan_invocations += 1
            rows.append(losses)
            start = n_scan
        for (existing, missing, gt), gen in zip(batches[start:], generators[start:]):
            loss, loss_r, loss_k, rec = self.train_step(*self._batch(existing, missing, gt), gen,
                                                        float(epoch), int(gt.shape[1]))
            rows.append(torch.stack([loss, loss_r, loss_k])[None])
        self.updates += len(batches)
        self._log_chamfer_route()
        # one device fetch per epoch, as in the step loop
        self.last_step_losses = torch.cat(rows).cpu().numpy()
        sums = self.last_step_losses.sum(axis=0)
        latest = (batches[-1][0], batches[-1][2], rec.float().cpu().numpy())
        return EpochStats(*(sums / len(batches))), latest

    def val_epoch(self, epoch: int):
        """Per-category no-grad loss and one sample per category (epoch_loops.py:49-83)."""
        if self._val_epoch_scan_fn is not None:
            return self._val_epoch_scan(epoch)
        val_losses: dict[str, np.ndarray] = {}
        val_samples: dict[str, tuple | None] = {}
        for cat, loader in self.val_loaders.items():
            losses, last = [], None
            for existing, missing, gt, _ in loader.epoch(epoch):
                ex, mi, g = self._batch(existing, missing, gt)
                loss, rec = self.val_step(ex, mi, g, self._next_generator(), float(epoch),
                                          int(gt.shape[1]))
                losses.append(loss)
                last = (existing[0], gt[0], rec)
            total = float(torch.stack(losses).sum()) if losses else 0.0
            if last is not None:
                last = (last[0], last[1], last[2][0].float().cpu().numpy())
            val_losses[cat] = np.array([total / max(len(losses), 1)])
            val_samples[cat] = last
        total = sum(val_losses.values()) / len(val_losses) if val_losses else np.array([0.0])
        val_losses["total"] = total
        return val_losses, val_samples

    def _val_epoch_scan(self, epoch: int):
        """``val_epoch`` with each category's uniform prefix through one
        scanned call and its ragged tail through the val step."""
        val_losses: dict[str, np.ndarray] = {}
        val_samples: dict[str, tuple | None] = {}
        for cat, loader in self.val_loaders.items():
            batches, generators = self._collect(loader, epoch)
            if not batches:
                val_losses[cat], val_samples[cat] = np.array([0.0]), None
                continue
            n_scan = _uniform_prefix(batches)
            losses, rec, start = [], None, 0
            if n_scan > 1:
                scanned, rec = self._val_epoch_scan_fn(*self._stacked(batches[:n_scan]),
                                                       generators[:n_scan], float(epoch),
                                                       int(batches[0][2].shape[1]))
                self.val_scan_invocations += 1
                losses.append(scanned)
                start = n_scan
            for (existing, missing, gt), gen in zip(batches[start:], generators[start:]):
                loss, rec = self.val_step(*self._batch(existing, missing, gt), gen, float(epoch),
                                          int(gt.shape[1]))
                losses.append(loss[None])
            total = float(torch.cat(losses).sum())
            val_losses[cat] = np.array([total / len(batches)])
            val_samples[cat] = (batches[-1][0][0], batches[-1][2][0],
                                rec[0].float().cpu().numpy())
        total = sum(val_losses.values()) / len(val_losses) if val_losses else np.array([0.0])
        val_losses["total"] = total
        return val_losses, val_samples

    # ------------------------------------------------------------------
    def run(self, *, plot_samples: bool = True, tg_logger=None):
        """Epochs ``start_epoch..max_epoch``: train, plot, validate, save."""
        profiler = None
        if self.profile_cfg.get("enable") and self.is_writer:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            profiler = profile(activities=activities)
            profiler.start()
        for epoch in range(self.start_epoch, self.max_epoch + 1):
            self._maybe_switch_dtype(epoch)
            t0 = time.monotonic()
            stats, latest = self.train_epoch(epoch)
            if (profiler is not None
                    and epoch >= self.start_epoch + self.profile_cfg.get("epochs", 1) - 1):
                self._write_trace(profiler)
                profiler = None
            self.train_losses.append(np.array([stats.loss_all, stats.loss_r, stats.loss_kld]))
            msg = (f"[{epoch}/{self.max_epoch}] Loss_ALL: {stats.loss_all:.4f} "
                   f"Loss_R: {stats.loss_r:.4f} Loss_E: {stats.loss_kld:.4f} "
                   f"Time: {time.monotonic() - t0:.1f}s")
            self.log.info(msg)

            plots = []
            if plot_samples and self.is_writer and latest is not None:
                from hyperpocket_tpu_torch.utils.plotting import save_plot

                l_existing, l_gt, l_rec = latest
                for k in range(min(5, l_rec.shape[0])):
                    plots.append(save_plot(l_existing[k].T, epoch, k, self.samples_path, "existing"))
                    plots.append(save_plot(l_rec[k].T, epoch, k, self.samples_path, "reconstructed"))
                    plots.append(save_plot(l_gt[k].T, epoch, k, self.samples_path, "gt"))
            if tg_logger is not None and self.is_writer:
                tg_logger.log_images(plots[:9], msg)

            epoch_val_losses, epoch_val_samples = self.val_epoch(epoch)
            is_new_best = float(epoch_val_losses["total"][0]) < self.best_epoch_loss
            if is_new_best:
                self.best_epoch_loss = float(epoch_val_losses["total"][0])
            self.val_losses.append(epoch_val_losses["total"])
            val_msg = f"val results[{self.loss_coef}*our_cd]:\n" + "".join(
                f"{k}: {v}\n" for k, v in epoch_val_losses.items())
            if is_new_best:
                val_msg += "new best epoch"
            self.log.info(val_msg)

            if plot_samples and self.is_writer:
                from hyperpocket_tpu_torch.utils.plotting import save_plot

                for cat, sample in epoch_val_samples.items():
                    if sample is None:
                        continue
                    save_plot(sample[0].T, epoch, cat, self.samples_path, "val_existing")
                    save_plot(sample[2].T, epoch, cat, self.samples_path, "val_rec")
                    save_plot(sample[1].T, epoch, cat, self.samples_path, "val_gt")

            if (epoch % self.save_freq == 0 or is_new_best) and epoch > self.min_save_epoch:
                sched_state = {"epoch": epoch, "lr": self.lr_schedule(epoch),
                               "seed_counter": int(self._seed_counter)}
                args = (self.weights_path, self.metrics_path, epoch, self.model, self.optimizer,
                        self.updates, sched_state, self.train_losses, self.val_losses)
                # every rank gathers the tensor-parallel shards; rank 0 writes
                with unsharded(self.mesh, self.model, self.optimizer):
                    if self.is_writer and self._async_ckpt is not None:
                        saved = self._async_ckpt.submit(*args)
                        self.log.debug("Epoch: %s %s", epoch, "save submitted" if saved
                                       else "save deferred (writer busy)")
                    elif self.is_writer:
                        ckpt.save_checkpoint(*args)
                        self.log.debug("Epoch: %s saved", epoch)
                if tg_logger is not None and self.is_writer:
                    tg_logger.log(f"Epoch: {epoch} saved")
        if profiler is not None:
            self._write_trace(profiler)
        if self._async_ckpt is not None:
            self._async_ckpt.wait()
        return self.train_losses, self.val_losses

    def _write_trace(self, profiler) -> None:
        """Stop the profiler and write its Chrome trace to ``training.profile.dir``
        (default ``<results>/trace``)."""
        profiler.stop()
        trace_dir = self.profile_cfg.get("dir") or join(self.result_dir, "trace")
        makedirs(trace_dir, exist_ok=True)
        profiler.export_chrome_trace(join(trace_dir, "trace.json"))
        self.log.info("profiler trace written to %s", trace_dir)
