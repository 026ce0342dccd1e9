"""The train step and the val step.

Port of ``make_train_step`` and ``make_val_step`` in
``hyperpocket_tpu/train/trainer.py``. A step is one forward with autograd,
the Chamfer + KLD loss, one backward and one optimizer update, eagerly on the
model's device. Randomness comes from an explicit ``torch.Generator``; the
``vae_eps``/``ball_points`` hooks replace the two draws with given values.

The ``Trainer`` class, its epoch loops and checkpoint saving are not ported
yet (ROADMAP.md, slice 3).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from hyperpocket_tpu_torch.models.full_model import FullModel
from hyperpocket_tpu_torch.train.losses import kld_loss, reconstruction_loss


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


def make_train_step(model: FullModel, optimizer: torch.optim.Optimizer,
                    loss_coef: float) -> Callable:
    """Returns ``step(existing, missing, gt, generator, epoch, num_points,
    vae_eps=None, ball_points=None) -> (loss, loss_r, loss_k, rec)``.

    The step updates ``model``'s parameters in place through ``optimizer``.
    The returned tensors are detached.
    """

    def step(existing, missing, gt, generator, epoch, num_points, vae_eps=None,
             ball_points=None):
        optimizer.zero_grad(set_to_none=True)
        rec, mu, sigma = model.apply(existing, missing, generator, epoch,
                                     num_output_points=num_points, training=True,
                                     vae_eps=vae_eps, ball_points=ball_points)
        loss_r = reconstruction_loss(gt, rec, loss_coef)
        if model.has_generativity:
            loss_k = kld_loss(mu, sigma, existing.shape[0])
        else:
            loss_k = torch.zeros((), dtype=loss_r.dtype, device=loss_r.device)
        loss = loss_r + loss_k
        loss.backward()
        optimizer.step()
        return loss.detach(), loss_r.detach(), loss_k.detach(), rec.detach()

    return step


def make_val_step(model: FullModel, loss_coef: float) -> Callable:
    """Returns ``step(existing, missing, gt, generator, epoch, num_points) ->
    (loss, rec)``: the inference forward and the reconstruction loss, with no
    gradient."""

    @torch.no_grad()
    def step(existing, missing, gt, generator, epoch, num_points):
        rec = model.apply(existing, missing, generator, epoch, num_output_points=num_points,
                          training=False)
        return reconstruction_loss(gt, rec, loss_coef), rec

    return step
