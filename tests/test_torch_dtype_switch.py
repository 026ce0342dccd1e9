"""The ``compute_dtype_switch`` crossed by the epoch routine, on the CPU.

``Trainer.train_epoch`` crosses ``training.compute_dtype_switch`` itself,
so a caller that drives epochs one by one (the benchmark's training
traffic, a notebook) gets each epoch's dtype, as ``Trainer.run`` does, and
``run`` crosses it once, through ``train_epoch``. Each train epoch counts
one under ``trainer.compute_dtype.<dtype>``, and the crossing is logged
once. Past the switch the training step takes the fp32
routes: the encoders' "sparse" trunk (clouds of 1024 points) and the
decode's ``bmm`` chain. A few seconds a case.
"""

from __future__ import annotations

import logging
from os.path import join

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hyperpocket_tpu_torch.train import trainer
from hyperpocket_tpu_torch.utils import profiling
from tests.test_data import make_synthetic_shapenet
from tests.test_train_integration import make_config

EPOCHS = 3
DTYPE = "trainer.compute_dtype."


@pytest.fixture(autouse=True)
def clean_totals():
    profiling.reset()
    yield
    profiling.reset()


def _tree(root, n_gt: int, n_part: int):
    """4 train objects (2 scanned steps at batch 2) and 2 val objects."""
    names = make_synthetic_shapenet(root, n_models=6, n_gt=n_gt, n_part=n_part)
    for split, sel in (("train", names[:4]), ("val", names[4:]), ("test", names[:1])):
        with open(join(root, split + ".list"), "w") as fh:
            fh.write("\n".join(sel) + "\n")
    return root


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return _tree(tmp_path_factory.mktemp("small"), 64, 32)


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """Partial clouds of 1024 points: the trunk's "sparse" route in fp32."""
    return _tree(tmp_path_factory.mktemp("wide"), 2048, 1024)


def _config(root, results, switch_epoch: int) -> dict:
    """The fast recipe at tiny widths: bf16 compute and moments, "high"
    matmuls, the switch to fp32 after ``switch_epoch``, scanned epochs, no
    checkpoints."""
    config = make_config(root, results, max_epoch=EPOCHS, batch=2)
    tr = config["training"]
    tr.update(compute_dtype="bfloat16", matmul_precision="high", epoch_mode="scan",
              min_save_epoch=EPOCHS,
              compute_dtype_switch={"epoch": switch_epoch, "compute_dtype": "float32"})
    tr["optimizer"]["hyperparams"]["moment_dtype"] = "bfloat16"
    for part in ("train", "val"):
        tr["dataloader"][part]["num_workers"] = 0
    return config


def _spied(t: trainer.Trainer) -> list:
    """The model's compute dtype at each scanned train call: what a card's
    ``EpochScan`` keys its graph on (a new dtype captures anew)."""
    seen, scan = [], t._epoch_scan_fn

    def call(*args):
        seen.append(t.model.compute_dtype)
        return scan(*args)

    t._epoch_scan_fn = call
    return seen


def test_a_switch_at_epoch_0_trains_epoch_1_in_fp32_through_the_fp32_routes(wide, tmp_path):
    t = trainer.Trainer(_config(wide, tmp_path, 0), device="cpu")
    assert t.model.compute_dtype == "bfloat16"  # the crossing is the epoch's, not the build's
    with profiling.collected() as counts:
        t.train_epoch(1)
    assert t.model.compute_dtype == "float32" and t.scan_invocations == 1
    steps = len(t.last_step_losses)
    assert steps == 2 and np.isfinite(t.last_step_losses).all()
    routes = {k: n for k, n in counts.items() if k != "adam_lowp.values"}  # bf16 moments
    assert routes == {f"{DTYPE}float32": 1, "encoder.trunk_route.sparse": 2 * steps,
                      "decoder.grad_route.chain": steps}
    assert counts["adam_lowp.values"] > 0
    assert torch.get_float32_matmul_precision() == "high"
    assert profiling.totals() == {}  # tallied into the collection only: no profiler


def _driven(root, results) -> dict:
    """Epochs 1..EPOCHS through ``train_epoch`` and ``val_epoch`` alone."""
    t = trainer.Trainer(_config(root, results, 1), device="cpu")
    dtypes = _spied(t)
    rows, val = [], []
    with profile(activities=[ProfilerActivity.CPU]):
        for epoch in range(1, EPOCHS + 1):
            t.train_epoch(epoch)
            rows.append(t.last_step_losses.copy())
            val.append(t.val_epoch(epoch)[0]["total"])
    return {"rows": rows, "val": val, "dtypes": dtypes, "trainer": t,
            "totals": {k: n for k, (n, _) in profiling.totals().items()}}


def _run(root, results) -> dict:
    """``Trainer.run`` over the same epochs, each train epoch's rows recorded."""
    t = trainer.Trainer(_config(root, results, 1), device="cpu")
    dtypes, rows, train_epoch = _spied(t), [], t.train_epoch

    def recorded(epoch):
        out = train_epoch(epoch)
        rows.append(t.last_step_losses.copy())
        return out

    t.train_epoch = recorded
    with profile(activities=[ProfilerActivity.CPU]):
        _, val = t.run(plot_samples=False)
    return {"rows": rows, "val": val, "dtypes": dtypes, "trainer": t,
            "totals": {k: n for k, (n, _) in profiling.totals().items()}}


class _Crossings(logging.Handler):
    """The crossings the Trainer logs, on its own logger (the Trainer's
    logging set-up replaces the root logger's handlers)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.n = 0

    def emit(self, record):
        self.n += "compute_dtype switched" in record.getMessage()

    def take(self) -> int:
        n, self.n = self.n, 0
        return n


@pytest.fixture
def crossings():
    log = logging.getLogger("hyperpocket_tpu_torch")
    handler, level = _Crossings(), log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    yield handler
    log.removeHandler(handler)
    log.setLevel(level)


def test_epochs_driven_one_by_one_cross_once_as_run_does(small, tmp_path, crossings):
    driven = _driven(small, tmp_path / "driven")
    driven["crossings"] = crossings.take()
    profiling.reset()
    ran = _run(small, tmp_path / "run")
    ran["crossings"] = crossings.take()
    for got in (driven, ran):
        # bf16 for epoch 1, fp32 from epoch 2: one new key, one new capture on a card
        assert got["dtypes"] == ["bfloat16", "float32", "float32"]
        assert got["trainer"].model.compute_dtype == "float32"
        totals = got["totals"]
        assert got["crossings"] == 1
        assert (totals[f"{DTYPE}bfloat16"], totals[f"{DTYPE}float32"]) == (1, EPOCHS - 1)
        assert totals["trainer.train_epoch"] == EPOCHS
    for epoch in range(EPOCHS):
        np.testing.assert_array_equal(driven["rows"][epoch], ran["rows"][epoch])
        np.testing.assert_array_equal(driven["val"][epoch], ran["val"][epoch])
    assert not np.array_equal(driven["rows"][1], driven["rows"][0])
    for (name, a), (_, b) in zip(driven["trainer"].model.named_parameters(),
                                 ran["trainer"].model.named_parameters()):
        assert torch.equal(a, b), name


def test_past_the_switch_no_bf16_route_runs_and_none_is_counted(small, tmp_path, crossings):
    """A switch already behind the run's first epoch: every epoch fp32, no
    crossing after the first, no bf16 epoch counted."""
    t = trainer.Trainer(_config(small, tmp_path, 0), device="cpu")
    with profiling.collected() as counts, profile(activities=[ProfilerActivity.CPU]):
        for epoch in range(1, EPOCHS + 1):
            t.train_epoch(epoch)
    assert counts[f"{DTYPE}float32"] == EPOCHS and f"{DTYPE}bfloat16" not in counts
    assert crossings.take() == 1
    assert not any(k.endswith((".k8", ".k10")) for k in counts), counts
