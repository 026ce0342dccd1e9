"""Training losses: port of ``hyperpocket_tpu/train/losses.py``.

* ``reconstruction_loss``: ``loss_coef * chamfer_loss_auto(gt, rec)``, the
  Chamfer *sum* over batch and points (``ops/nn.py`` sends fp32 aligned
  clouds to the CUDA kernels).
* ``kld_loss``: the reference's expression with its quirk kept: the value
  handed over as "logvar" is ``sigma = exp(std_head)``, and the loss is
  ``0.5 * sum(exp(sigma) + mu^2 - 1 - sigma) / batch`` on it.
"""

from __future__ import annotations

import torch

from hyperpocket_tpu_torch.ops.nn import chamfer_loss_auto


def reconstruction_loss(gt: torch.Tensor, rec: torch.Tensor,
                        loss_coef: float = 0.05) -> torch.Tensor:
    return loss_coef * chamfer_loss_auto(gt, rec)


def kld_loss(mu: torch.Tensor, sigma: torch.Tensor, batch_size: int) -> torch.Tensor:
    return 0.5 * torch.sum(torch.exp(sigma) + torch.square(mu) - 1.0 - sigma) / batch_size
