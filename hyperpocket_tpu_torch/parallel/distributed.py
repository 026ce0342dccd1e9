"""Process-group setup: one process per device.

Counterpart of ``hyperpocket_tpu/parallel/distributed.py``. JAX drives every
device of a host from one process; the port runs one process per device in
a ``torch.distributed`` group, launched by ``torchrun``, which sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``. The backend is NCCL on CUDA and gloo when the caller asks
for the CPU. A rank's device is ``cuda:LOCAL_RANK``.

``initialize_multihost`` is idempotent and returns False in a one-process
run with no launcher environment. Without a group, ``rank()`` is 0 and
``world_size()`` 1.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger("hyperpocket_tpu_torch.distributed")


def _int_env(name: str) -> int | None:
    val = os.environ.get(name)
    return int(val) if val is not None else None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize_multihost(init_method: str | None = None, world_size: int | None = None,
                         rank: int | None = None, *, device: str | torch.device = "cuda") -> bool:
    """Join the process group when running multi-process; True if a group is up.

    The arguments default to ``torchrun``'s ``WORLD_SIZE`` and ``RANK`` with
    the ``env://`` rendezvous; ``init_method`` may instead name a store
    (``file://<path>``, ``tcp://localhost:<port>``). The backend is NCCL
    for a ``cuda`` device, which also becomes the current device, and gloo
    for ``cpu``.
    """
    if is_initialized():
        return True
    world_size = world_size if world_size is not None else _int_env("WORLD_SIZE")
    rank = rank if rank is not None else _int_env("RANK")
    if init_method is None and world_size is None:
        log.debug("single-process run; no process group")
        return False
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        torch.cuda.set_device(_cuda_index(rank or 0))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method or "env://", world_size=world_size,
                            rank=rank)
    log.info("process group up: rank %d of %d (%s)", dist.get_rank(), dist.get_world_size(),
             dist.get_backend())
    return True


def shutdown() -> None:
    """Leave the process group, if one is up."""
    if is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0: the one process that writes logs, metrics, samples and checkpoints."""
    return rank() == 0


def _cuda_index(global_rank: int) -> int:
    local = _int_env("LOCAL_RANK")
    return local if local is not None else global_rank % max(torch.cuda.device_count(), 1)


def rank_device(device: str | torch.device = "cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (rank modulo the card count
    without a launcher) for ``cuda``; any other device as given."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return torch.device("cuda", _cuda_index(rank()))


def local_batch_slice(global_batch: int) -> slice:
    """This rank's rows of a batch split over every rank (per-rank loading)."""
    per_rank = global_batch // world_size()
    start = rank() * per_rank
    return slice(start, start + per_rank)
