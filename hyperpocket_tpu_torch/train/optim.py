"""Optimizers and per-epoch learning-rate schedules.

Port of ``hyperpocket_tpu/train/optim.py``. The config schema is the
reference's (``{"type": "Adam", "hyperparams": {...}}``) and the update of
each optimizer is the JAX package's optax chain:

* Adam (L2 decay *coupled*: added to the gradient before the moments),
  AdamW (decay decoupled) and SGD (momentum, Nesterov, coupled decay) are
  ``torch.optim``'s, whose updates equal those chains;
* AMSGrad and RMSprop are written here, because ``torch.optim`` computes
  them otherwise. optax's ``scale_by_amsgrad`` keeps the maximum of the
  *bias-corrected* second moment (torch's of the raw one), and its
  ``scale_by_rms`` divides by ``sqrt(nu + eps)`` (torch's RMSprop by
  ``sqrt(nu) + eps``).

* Adam and AdamW with ``moment_dtype`` (``AdamLowp``) are the JAX
  package's ``scale_by_adam_lowp``: both moments stored in the narrow
  dtype, their update computed in the gradient's dtype and rounded on
  store, the bias correction ``1 - b^count`` in fp32. Each tensor's update
  is ``ops/adam_lowp.py::adam_lowp_update``: on a card one pass of the
  kernel ``csrc/adam_lowp.cu`` a tensor, bit-equal to the plain torch
  arithmetic, which the CPU runs.

Frozen hypernetwork heads are left out of the optimizer, as the reference
leaves them out of its parameters. Every optimizer here can be captured in
a CUDA graph (``train/epoch_scan.py``): on a card torch's Adam and AdamW
run with ``capturable=True``, the ones written here keep their count on the
parameter's device and update their slots in place; the CPU's arithmetic
is unchanged.

``make_lr_schedule`` returns ``lr_for_epoch(epoch)`` for 1-indexed epochs
with torch's scheduler convention; ``set_learning_rate`` writes it into the
optimizer between epochs.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

from hyperpocket_tpu_torch.models.full_model import _DTYPES
from hyperpocket_tpu_torch.ops.adam_lowp import adam_lowp_update


def step_count(p: torch.Tensor, value: float = 0.0) -> torch.Tensor:
    """An optimizer's update count for ``p``: an fp32 scalar on its device,
    where a captured step can increment it."""
    return torch.full((), float(value), dtype=torch.float32, device=p.device)


class OptaxAmsgrad(torch.optim.Optimizer):
    """AMSGrad as optax's ``scale_by_amsgrad``, with optional L2 decay.

    ``decoupled`` selects AdamW's decay (added to the update) over Adam's
    (added to the gradient). The count is a tensor on the parameter's
    device and every slot is updated in place, so a CUDA graph can capture
    the step; the bias correction ``1 - b^count`` is taken in fp64, as
    Python's float power took it.
    """

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool = False):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, decoupled=decoupled))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            wd = group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if wd and not group["decoupled"]:
                    g = g + wd * p
                state = self.state[p]
                if not state:
                    state["step"] = step_count(p)
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                    state["nu_max"] = torch.zeros_like(p)
                state["step"].add_(1)
                t = state["step"].double()
                state["mu"].mul_(b1).add_((1 - b1) * g)
                state["nu"].mul_(b2).add_((1 - b2) * g * g)
                mu_hat = state["mu"] / (1 - b1 ** t)
                torch.maximum(state["nu_max"], state["nu"] / (1 - b2 ** t), out=state["nu_max"])
                update = mu_hat / (torch.sqrt(state["nu_max"]) + group["eps"])
                if wd and group["decoupled"]:
                    update = update + wd * p
                p.add_(-group["lr"] * update)
        return loss


class AdamLowp(torch.optim.Optimizer):
    """Adam as the JAX package's ``scale_by_adam_lowp``, with optional L2 decay.

    The moments ``mu`` and ``nu`` are stored in ``moment_dtype`` under
    torch's Adam names, ``exp_avg`` and ``exp_avg_sq``, so every reader of
    an Adam's moments reads one layout (``train/checkpoint.py`` writes them
    as optax's ``mu`` and ``nu``). Each step computes them in the
    gradient's dtype from the stored values and rounds them on store, and
    the update reads the stored (rounded) moments in fp32:
    ``(mu / bc1) / (sqrt(nu / bc2) + eps)`` with ``bc = 1 - b^step`` in
    fp32. ``decoupled`` selects AdamW's decay (added to the update) over
    Adam's (added to the gradient). As in ``OptaxAmsgrad`` the count lives
    on the parameter's device and the moments are updated in place.
    """

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool = False,
                 moment_dtype: torch.dtype = torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, decoupled=decoupled,
                                      moment_dtype=moment_dtype))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        f32 = torch.float32
        for group in self.param_groups:
            b1, b2 = group["betas"]
            md = group["moment_dtype"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = step_count(p)
                    state["exp_avg"] = torch.zeros_like(p, dtype=md)
                    state["exp_avg_sq"] = torch.zeros_like(p, dtype=md)
                state["step"].add_(1)
                t = state["step"]
                # fills, not copies from the host: the step stays capturable
                bc1 = 1 - torch.full((), b1, dtype=f32, device=t.device) ** t
                bc2 = 1 - torch.full((), b2, dtype=f32, device=t.device) ** t
                adam_lowp_update(p, p.grad, state["exp_avg"], state["exp_avg_sq"], bc1, bc2,
                                 lr=group["lr"], b1=b1, b2=b2, eps=group["eps"],
                                 weight_decay=group["weight_decay"],
                                 decoupled=group["decoupled"])
        return loss


class OptaxRMSprop(torch.optim.Optimizer):
    """RMSprop as optax's ``scale_by_rms`` (``eps`` inside the square root),
    after coupled L2 decay."""

    def __init__(self, params, lr: float, alpha: float = 0.99, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            alpha, wd = group["alpha"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad + wd * p if wd else p.grad
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                state["nu"].mul_(alpha).add_((1 - alpha) * g * g)
                p.add_(-group["lr"] * g * torch.rsqrt(state["nu"] + group["eps"]))
        return loss


def trainable_parameters(model) -> list[torch.nn.Parameter]:
    """Every parameter but frozen hypernetwork heads."""
    return [p for name, p in model.named_parameters()
            if not (model.freeze_heads and name.startswith("hyper_network.heads."))]


def make_optimizer(opt_config: dict, params: Iterable[torch.nn.Parameter],
                   moment_dtype: str | None = None) -> torch.optim.Optimizer:
    """Build the optimizer of a reference-schema config over ``params``.

    Pass ``trainable_parameters(model)`` to leave frozen heads out.
    ``moment_dtype`` (or ``hyperparams.moment_dtype``, which wins) stores
    Adam's moments in that dtype.
    """
    kind = opt_config["type"]
    hp = dict(opt_config.get("hyperparams", {}))
    lr = float(hp.pop("lr", 1e-3))
    params = list(params)

    if kind in ("Adam", "AdamW"):
        b1, b2 = hp.pop("betas", (0.9, 0.999))
        eps = float(hp.pop("eps", 1e-8))
        wd = float(hp.pop("weight_decay", 0.0))
        amsgrad = bool(hp.pop("amsgrad", False))
        moment_dtype = hp.pop("moment_dtype", moment_dtype)
        if amsgrad and moment_dtype is not None:
            raise ValueError("moment_dtype is not supported with amsgrad=true "
                             "(scale_by_amsgrad keeps fp32 moments); drop one of the two")
        betas = (float(b1), float(b2))
        if moment_dtype is not None:
            return AdamLowp(params, lr, betas, eps, wd, decoupled=kind == "AdamW",
                            moment_dtype=_DTYPES[str(moment_dtype)])
        if amsgrad:
            return OptaxAmsgrad(params, lr, betas, eps, wd, decoupled=kind == "AdamW")
        # on a card the count and the bias correction stay on the device, so
        # that a CUDA graph can capture the step (train/epoch_scan.py); the
        # step loop uses the same arithmetic
        capturable = bool(params) and params[0].is_cuda
        opt = torch.optim.Adam if kind == "Adam" else torch.optim.AdamW
        return opt(params, lr=lr, betas=betas, eps=eps, weight_decay=wd, capturable=capturable)
    if kind == "SGD":
        return torch.optim.SGD(params, lr=lr, momentum=float(hp.pop("momentum", 0.0)),
                               weight_decay=float(hp.pop("weight_decay", 0.0)),
                               nesterov=bool(hp.pop("nesterov", False)))
    if kind == "RMSprop":
        return OptaxRMSprop(params, lr, alpha=float(hp.pop("alpha", 0.99)),
                            eps=float(hp.pop("eps", 1e-8)),
                            weight_decay=float(hp.pop("weight_decay", 0.0)))
    raise ValueError(f"unsupported optimizer type: {kind!r}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Set every parameter group's learning rate (in place); returns the optimizer."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer


def make_lr_schedule(sched_config: dict | None, base_lr: float) -> Callable[[int], float]:
    """Return ``lr_for_epoch(epoch)`` for 1-indexed epochs.

    torch semantics: the scheduler's internal counter is ``epoch - 1`` while
    epoch ``e`` is running (scheduler.step() fires at the end of each epoch).
    """
    if not sched_config:
        return lambda epoch: base_lr
    kind = sched_config["type"]
    hp = dict(sched_config.get("hyperparams", {}))

    if kind == "StepLR":
        step_size = int(hp["step_size"])
        gamma = float(hp.get("gamma", 0.1))
        return lambda epoch: base_lr * gamma ** ((epoch - 1) // step_size)
    if kind == "MultiStepLR":
        milestones = sorted(int(m) for m in hp["milestones"])
        gamma = float(hp.get("gamma", 0.1))
        return lambda epoch: base_lr * gamma ** sum(1 for m in milestones if (epoch - 1) >= m)
    if kind == "ExponentialLR":
        gamma = float(hp["gamma"])
        return lambda epoch: base_lr * gamma ** (epoch - 1)
    if kind == "CosineAnnealingLR":
        t_max = int(hp["T_max"])
        eta_min = float(hp.get("eta_min", 0.0))
        return lambda epoch: eta_min + (base_lr - eta_min) * (
            1 + math.cos(math.pi * (epoch - 1) / t_max)
        ) / 2
    if kind in ("ConstantLR", "LambdaLR", "None"):
        return lambda epoch: base_lr
    raise ValueError(f"unsupported lr_scheduler type: {kind!r}")
