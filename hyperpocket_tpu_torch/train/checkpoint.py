"""Checkpoint save and restore in the JAX package's results layout.

Port of ``hyperpocket_tpu/train/checkpoint.py``. A checkpoint of epoch e is
``weights/{e:05}_model.npz`` (parameters), ``{e:05}_O.npz`` (optimizer
state), ``{e:05}_S.json`` (schedule bookkeeping and the step-seed counter)
and ``metrics/{e:05}_{train,val}.npy`` (the loss curves). Restore policies
are the reference's ``latest`` / ``best_val`` / explicit int
(core/setup.py:80-101).

The ``.npz`` files are the JAX package's positional format, so each package
restores what the other saved: leaves ``arr_0..arr_k`` in
``jax.tree_util.tree_flatten`` order, weights as (in, out).

* ``_model.npz``: the parameters in ``convert.jax_leaf_names`` order, in
  their dtype (fp64 in the trajectory-parity mode).
* ``_O.npz``: optax's state of the JAX package's optimizer chain: the
  ``inject_hyperparams`` step count (int32) and learning rate (fp32), then
  the transform's leaves over the trainable parameters in the same order
  (the rate is fp64 in the fp64 parity mode, where JAX runs with x64).
  Adam and AdamW: their count (int32), every ``mu``, every ``nu``; AMSGrad
  adds every ``nu_max``; SGD with momentum: every ``trace``; RMSprop: every
  ``nu``; plain SGD: nothing. A frozen-heads mask only drops the heads'
  leaves (optax's masked nodes hold none). Moments in bf16 are stored as
  the JAX package stores them: their raw 2-byte words, numpy dtype ``|V2``.
  torch's Adam state (``step``, ``exp_avg``, ``exp_avg_sq``), which
  ``AdamLowp`` keeps too, maps to the count, ``mu`` and ``nu``.

No ``__structure__`` fingerprint is written (it hashes JAX's treedef repr);
the JAX loader accepts such a file with its leaf-count and shape checks,
and so does this one.
"""

from __future__ import annotations

import json
import re
import threading
from os import listdir, makedirs
from os.path import exists, join

import numpy as np
import torch

from hyperpocket_tpu_torch.convert import _jax_layout, jax_leaf_names, jax_leaves, load_jax_npz
from hyperpocket_tpu_torch.models.full_model import FullModel
from hyperpocket_tpu_torch.train.config import get_results_dir_path
from hyperpocket_tpu_torch.train.optim import AdamLowp, OptaxAmsgrad, OptaxRMSprop, step_count

_EPOCH_RE = re.compile(r"^(?P<n>\d+)_(model\.npz|model\.pth|[DEG]\.pth)$")
_BF16_WORDS = np.dtype("V2")


def _saved_epochs(weights_path: str) -> set[int]:
    if not exists(weights_path):
        return set()
    return {int(m.group("n")) for f in listdir(weights_path) if (m := _EPOCH_RE.match(f))}


def find_latest_epoch(dirpath: str) -> int:
    """Max epoch among saved weights (reference utils/util.py:13-23)."""
    if exists(join(dirpath, "weights")):
        dirpath = join(dirpath, "weights")
    return max(_saved_epochs(dirpath), default=0)


def find_latest_resumable_epoch(weights_path: str, metrics_path: str) -> int:
    """Max epoch with a complete resume state: model, optimizer and both metrics.

    An epoch with a model file alone (a write cut short, a model copied in
    for experiments) cannot be resumed and is skipped. Experiments restore
    parameters only and use ``find_latest_epoch``.
    """
    for epoch in sorted(_saved_epochs(weights_path), reverse=True):
        if all(exists(p) for p in (
                join(weights_path, f"{epoch:05}_model.npz"),
                join(weights_path, f"{epoch:05}_O.npz"),
                join(metrics_path, f"{epoch:05}_train.npy"),
                join(metrics_path, f"{epoch:05}_val.npy"))):
            return epoch
    return 0


def resolve_restore_epoch(metrics_path: str, epoch: int, restore_policy,
                          weights_path: str | None = None) -> int:
    """``latest`` -> epoch; ``best_val`` -> argmin of the saved val curve + 1,
    among epochs whose weights exist when ``weights_path`` is given; else int."""
    if restore_policy == "latest":
        return epoch
    if restore_policy == "best_val":
        val = np.load(join(metrics_path, f"{epoch:05}_val.npy"), allow_pickle=True)
        val = np.asarray(val, dtype=np.float64).reshape(len(val), -1)[:, 0]
        if weights_path is not None:
            saved = _saved_epochs(weights_path)
            candidates = [e for e in range(1, len(val) + 1) if e in saved]
            if candidates:
                return min(candidates, key=lambda e: val[e - 1])
        return int(np.argmin(val)) + 1
    try:
        return int(restore_policy)
    except (TypeError, ValueError):
        raise ValueError(
            "`[epoch]` value can take only values: `latest`, `best_val` or positive integer"
        )


# ---------------------------------------------------------------------------
# The optimizer state as optax's leaves


def _slots(optimizer: torch.optim.Optimizer) -> tuple[bool, list[str]]:
    """(whether the transform has a count leaf, the port's state keys of its
    per-parameter slots in optax's order)."""
    if isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW, AdamLowp)):
        return True, ["exp_avg", "exp_avg_sq"]
    if isinstance(optimizer, OptaxAmsgrad):
        return True, ["mu", "nu", "nu_max"]
    if isinstance(optimizer, OptaxRMSprop):
        return False, ["nu"]
    if isinstance(optimizer, torch.optim.SGD):
        return False, ["momentum_buffer"] if optimizer.defaults["momentum"] else []
    raise TypeError(f"no optax state layout for {type(optimizer).__name__}")


def _slot_dtype(optimizer, p: torch.Tensor) -> torch.dtype:
    return optimizer.param_groups[0]["moment_dtype"] if isinstance(optimizer, AdamLowp) else p.dtype


def _ordered_params(model: FullModel, optimizer) -> list[tuple[str, torch.nn.Parameter]]:
    """The optimizer's parameters with their names, in the JAX leaf order."""
    held = {id(p) for group in optimizer.param_groups for p in group["params"]}
    by_name = dict(model.named_parameters())
    out = [(n, by_name[n]) for n in jax_leaf_names(model) if id(by_name[n]) in held]
    if len(out) != len(held):
        raise ValueError("the optimizer holds parameters that are not the model's")
    return out


def optimizer_leaves(model: FullModel, optimizer, count: int) -> list[torch.Tensor]:
    """The optimizer's state as the leaves of the JAX package's optax state.

    ``count`` is the number of updates made (the inject-hyperparams count
    and, where there is one, the transform's). A parameter not yet stepped
    holds zeros, as optax's freshly initialised state does.
    """
    has_count, keys = _slots(optimizer)
    params = _ordered_params(model, optimizer)
    # the learning rate is fp32, fp64 in the fp64 parity mode (JAX with x64)
    lr_dtype = torch.float64 if params[0][1].dtype == torch.float64 else torch.float32
    leaves = [torch.tensor(count, dtype=torch.int32),
              torch.tensor(optimizer.param_groups[0]["lr"], dtype=lr_dtype)]
    if has_count:
        leaves.append(torch.tensor(count, dtype=torch.int32))
    for key in keys:
        for name, p in params:
            t = optimizer.state[p].get(key)
            if t is None:
                t = torch.zeros_like(p, dtype=_slot_dtype(optimizer, p))
            leaves.append(_jax_layout(name, t.detach()))
    return leaves


def load_optimizer_leaves(path: str, model: FullModel, optimizer) -> int:
    """Restore the optimizer's state from a JAX-layout ``_O.npz``; returns the count."""
    has_count, keys = _slots(optimizer)
    params = _ordered_params(model, optimizer)
    arrays = _load_leaves(path)
    want = 2 + int(has_count) + len(keys) * len(params)
    if len(arrays) != want:
        raise ValueError(f"{path}: optimizer checkpoint has {len(arrays)} leaves, the "
                         f"{type(optimizer).__name__} state of this model has {want}")
    count = int(arrays[0])
    for group in optimizer.param_groups:
        group["lr"] = float(arrays[1])
    slots = arrays[2 + int(has_count):]
    for k, key in enumerate(keys):
        for i, (name, p) in enumerate(params):
            a = slots[k * len(params) + i]
            t = _jax_layout(name, a)
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{path}: {key} of {name} has shape {tuple(t.shape)}, "
                                 f"expected {tuple(p.shape)}")
            optimizer.state[p][key] = t.to(device=p.device,
                                           dtype=_slot_dtype(optimizer, p)).contiguous()
    for _, p in params:
        state = optimizer.state[p]
        if isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
            # a capturable Adam keeps its count beside the parameter
            capturable = optimizer.param_groups[0]["capturable"]
            state["step"] = torch.tensor(float(count), dtype=torch.float32,
                                         device=p.device if capturable else "cpu")
        elif has_count:
            state["step"] = step_count(p, count)
    return count


# ---------------------------------------------------------------------------
# .npz leaves


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A leaf as numpy; bf16 as its raw 2-byte words (``|V2``), as JAX writes it."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_WORDS)
    return t.numpy()


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == _BF16_WORDS:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _load_leaves(path: str) -> list[torch.Tensor]:
    with np.load(path) as data:
        n = sum(1 for f in data.files if f.startswith("arr_"))
        return [_to_torch(data[f"arr_{i}"]) for i in range(n)]


def _save_leaves(path: str, leaves: list[torch.Tensor]) -> None:
    np.savez(path, *[_to_numpy(t) for t in leaves])


def write_checkpoint(weights_path: str, metrics_path: str, epoch: int,
                     model_leaves: list[torch.Tensor], optimizer_leaves_: list[torch.Tensor],
                     scheduler_state: dict, train_losses, val_losses) -> None:
    """Write one epoch's five files from leaves already in the JAX layout."""
    makedirs(weights_path, exist_ok=True)
    makedirs(metrics_path, exist_ok=True)
    _save_leaves(join(weights_path, f"{epoch:05}_model.npz"), model_leaves)
    _save_leaves(join(weights_path, f"{epoch:05}_O.npz"), optimizer_leaves_)
    with open(join(weights_path, f"{epoch:05}_S.json"), "w") as fh:
        json.dump(scheduler_state, fh)
    np.save(join(metrics_path, f"{epoch:05}_train"), np.array(train_losses))
    np.save(join(metrics_path, f"{epoch:05}_val"), np.array(val_losses))


def save_checkpoint(weights_path: str, metrics_path: str, epoch: int, model: FullModel,
                    optimizer, count: int, scheduler_state: dict, train_losses,
                    val_losses) -> None:
    """Save epoch ``epoch`` of a run: parameters, optimizer state, schedule, metrics."""
    write_checkpoint(weights_path, metrics_path, epoch, jax_leaves(model),
                     optimizer_leaves(model, optimizer, count), scheduler_state,
                     train_losses, val_losses)


def restore_model_state(weights_path: str, metrics_path: str, epoch: int, restore_policy,
                        model: FullModel, optimizer=None) -> tuple[int, int | None]:
    """Load parameters (and the optimizer's state) in place.

    Returns ``(epoch, count)``: the epoch restored and, with an optimizer,
    the number of updates its state has made (else None).
    """
    epoch = resolve_restore_epoch(metrics_path, epoch, restore_policy, weights_path)
    load_jax_npz(join(weights_path, f"{epoch:05}_model.npz"), model)
    count = None
    if optimizer is not None:
        count = load_optimizer_leaves(join(weights_path, f"{epoch:05}_O.npz"), model, optimizer)
    return epoch, count


def restore_metrics(metrics_path: str, epoch: int):
    """(train_losses, val_losses, best_val) — reference core/setup.py:104-107."""
    train = np.load(join(metrics_path, f"{epoch:05}_train.npy"), allow_pickle=True)
    val = np.load(join(metrics_path, f"{epoch:05}_val.npy"), allow_pickle=True)
    return train.tolist(), val.tolist(), float(np.min(val))


def restore_trained_model(config: dict, restore_policy=None,
                          device: str | torch.device = "cuda"):
    """(model, epoch) from a training config's results tree, on ``device``.

    The model is built from ``config["full_model"]`` and restored with
    ``restore_policy`` (default: the config's ``experiments.epoch``, else
    ``latest``). As the JAX package restores onto its default device, the
    default is the card: without CUDA it raises unless ``device`` names the
    CPU. Raises FileNotFoundError when no checkpoint exists.
    """
    from hyperpocket_tpu_torch.serving import resolve_device

    device = resolve_device(device)
    training_dir = get_results_dir_path(config, "training")
    weights_path = join(training_dir, "weights")
    metrics_path = join(training_dir, "metrics")
    latest = find_latest_epoch(weights_path)
    if latest <= 0:
        raise FileNotFoundError(f"no weights found at {weights_path}")
    if restore_policy is None:
        restore_policy = config.get("experiments", {}).get("epoch", "latest")
    epoch = resolve_restore_epoch(metrics_path, latest, restore_policy, weights_path)
    generator = torch.Generator().manual_seed(int(config["setup"]["seed"]))
    model = FullModel.from_config(config["full_model"], generator)
    load_jax_npz(join(weights_path, f"{epoch:05}_model.npz"), model)
    return model.to(device), epoch


class AsyncCheckpointer:
    """Checkpoint writes on a background thread.

    ``submit`` snapshots the parameters and the optimizer state with a
    device-side ``clone()`` (so the next steps may update the live tensors)
    and writes the files on a thread. With ``drop_if_busy`` (the default) a
    save asked for while one is being written is deferred, and only the
    newest deferred request is kept (``dropped`` counts them); ``wait()``
    joins the writer and flushes it, so a run's last state is never lost.
    Without it, ``submit`` waits for the writer first.
    """

    def __init__(self, drop_if_busy: bool = True):
        self.drop_if_busy = drop_if_busy
        self.dropped = 0
        self._thread: threading.Thread | None = None
        self._pending: tuple | None = None

    def submit(self, weights_path: str, metrics_path: str, epoch: int, model: FullModel,
               optimizer, count: int, scheduler_state: dict, train_losses,
               val_losses) -> bool:
        """Snapshot and write in the background; False when deferred (writer busy)."""
        args = (weights_path, metrics_path, epoch,
                [t.clone() for t in jax_leaves(model)],
                [t.clone() for t in optimizer_leaves(model, optimizer, count)],
                dict(scheduler_state), list(train_losses), list(val_losses))
        if self._thread is not None and self._thread.is_alive():
            if self.drop_if_busy:
                self._pending = args
                self.dropped += 1
                return False
            self._thread.join()
        self._pending = None
        self._thread = threading.Thread(target=write_checkpoint, args=args, daemon=True)
        self._thread.start()
        return True

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
        if self._pending is not None:
            write_checkpoint(*self._pending)
            self._pending = None
