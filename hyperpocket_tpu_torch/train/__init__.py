"""Training runtime: config, optimizers, checkpointing and the epoch loops.

The names ``hyperpocket_tpu/train/__init__.py`` exports, where the port has
them (the JAX package's ``save_tree``/``load_tree`` are its tree format;
the port writes the same files through ``train/checkpoint.py``).
"""

from hyperpocket_tpu_torch.train.checkpoint import find_latest_epoch, resolve_restore_epoch
from hyperpocket_tpu_torch.train.losses import kld_loss, reconstruction_loss
from hyperpocket_tpu_torch.train.optim import make_lr_schedule, make_optimizer
from hyperpocket_tpu_torch.train.trainer import Trainer

__all__ = [
    "kld_loss",
    "reconstruction_loss",
    "make_optimizer",
    "make_lr_schedule",
    "find_latest_epoch",
    "resolve_restore_epoch",
    "Trainer",
]
