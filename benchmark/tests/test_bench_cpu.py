"""Cells driven on the CPU at small sizes: the reference against the
port's CPU path, the controls and the planted faults against the limits,
and a cell found by name from a folder of its own. About a minute."""

from __future__ import annotations

import copy
import hashlib
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.reference import quant

BENCH = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SMALL_SERVE = {"batch": 4, "pool_batches": 2, "sample_calls": 3,
               "trace_calls": 3}
SMALL_TRAIN = {"corpus": {"shapes": 8, "samples": 4, "n_gt": 512, "n_partial": 256,
                          "corpus_seed": 5}, "trace_epochs": 1}
TRAIN_SETTINGS = {"train": {"batch_size": 8, "num_workers": 2},
                  "val": {"batch_size": 6, "num_workers": 2}}


def small_root(tmp: Path, cell: str, params: dict) -> Path:
    """A copy of the benchmark's data files with ``cell`` cut to a CPU size."""
    for d in ("configs", "workloads", "traffic", "metrics"):
        shutil.copytree(BENCH / d, tmp / d)
    path = tmp / "workloads" / f"{cell}.json"
    workload = json.loads(path.read_text())
    workload["params"].update(copy.deepcopy(params))
    path.write_text(json.dumps(workload))
    if workload["driver"] == "train_epochs":
        cfg_path = tmp / "configs" / f"{workload['config']}.json"
        cfg = json.loads(cfg_path.read_text())
        for split, over in TRAIN_SETTINGS.items():
            cfg["settings"]["training"]["dataloader"][split].update(over)
        cfg_path.write_text(json.dumps(cfg))
    return tmp


def drive(root: Path, cell: str, trace: bool = False, seed: int = 2**31 + 17):
    outcome, metrics = harness.execute(cell, seed, 0.3, trace, CPU, time.perf_counter(), root)
    return outcome, metrics, harness.result_line(outcome, metrics, {"platform": "cpu"})


def make_run(root: Path, cell: str, seed: int = 2**31 + 5):
    workload, config = harness.load_cell(cell, root)
    return harness.Run(cell, workload, config, seed, 0.0, False, CPU, time.perf_counter(), root)


@pytest.mark.parametrize("cell", ["c3d_serve_submit_fp32", "chair_serve_bulk_bf16"])
def test_served_completions_agree_with_the_reference(tmp_path, cell):
    root = small_root(tmp_path, cell, SMALL_SERVE)
    outcome, metrics, line = drive(root, cell)
    assert line["correct"] and outcome.attempted >= 1 and outcome.failed == 0
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(metrics) == {"setup_s", "serve_clouds_per_s"}
    if cell.startswith("c3d"):  # fp32 against fp32: rounding alone
        assert outcome.checks[0].value < 1e-5


def test_the_training_cell_agrees_with_the_reference(tmp_path):
    root = small_root(tmp_path, "chair_train_fp32", SMALL_TRAIN)
    outcome, metrics, line = drive(root, "chair_train_fp32", trace=True)
    assert line["correct"], line["checks"]
    assert {c.name for c in outcome.checks} == {"loss1_gap", "grad1_gap", "delta3_gap",
                                                "wloss1_gap", "wgrad1_gap", "wstep1_gap",
                                                "val_gap"}
    assert outcome.counters["epochs"] >= 1 and outcome.attempted >= 4
    assert outcome.counters["detail"]["val_steps"] == 6  # 32 items in batches of 6
    assert "train.capture_ms_per_epoch" not in metrics  # no capture on the CPU


@pytest.mark.parametrize("cell, q", [("chair_serve_bulk_bf16", quant.fp8),
                                     ("c3d_serve_submit_fp32", quant.tf32)])
def test_the_serving_control_fails_the_limit(tmp_path, cell, q):
    root = small_root(tmp_path, cell, SMALL_SERVE)
    run = make_run(root, cell)
    driver = harness.load_module(root / "traffic" / "serve_closed_loop.py")
    assert driver.control(run, q) > run.params["limits"]["rel_gap"]


def test_the_training_control_and_a_half_batch_fail_a_limit(tmp_path):
    """Each fails a number of epoch 1 and one of the window's last epoch."""
    root = small_root(tmp_path, "chair_train_fp32", SMALL_TRAIN)
    run = make_run(root, "chair_train_fp32")
    driver = harness.load_module(root / "traffic" / "train_epochs.py")
    outcome = driver.run(run, variants=[("tf32", quant.tf32, None),
                                        ("half_batch", None, slice(0, 4))])
    limits = run.params["limits"]
    assert all(c.ok for c in outcome.checks), outcome.checks
    for name, gaps in outcome.counters["variants"].items():
        failed = {k for k in limits if gaps[k] > limits[k]}
        assert failed & {"loss1_gap", "grad1_gap", "delta3_gap"}, (name, gaps)
        assert failed & {"wloss1_gap", "wgrad1_gap", "wstep1_gap", "val_gap"}, (name, gaps)


def _altered(fn):
    def serve(existing, noise, seed):
        out = fn(existing, noise, seed).clone()
        out[0] = out[0].flip(0) + 0.05  # an answer altered where it is produced
        return out
    return serve


def _half(fn):
    def serve(existing, noise, seed):
        out = fn(existing, noise, seed).clone()
        half = out.shape[0] // 2
        out[half:] = out[:out.shape[0] - half]  # half of the batch left out
        return out
    return serve


@pytest.mark.parametrize("fault", [_altered, _half])
def test_a_broken_serving_path_is_not_correct(tmp_path, monkeypatch, fault):
    import hyperpocket_tpu_torch.serving as serving

    make = serving.make_serving_fn
    monkeypatch.setattr(serving, "make_serving_fn", lambda *a, **k: fault(make(*a, **k)))
    cell = "chair_serve_bulk_bf16"
    _, _, line = drive(small_root(tmp_path, cell, SMALL_SERVE), cell)
    assert not line["correct"], line["checks"]


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    root = small_root(tmp_path, "chair_train_fp32", SMALL_TRAIN)
    outcome, _, line = drive(root, "chair_train_fp32")
    assert not line["correct"]
    assert {c.name: c.value for c in outcome.checks}["delta3_gap"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_not_correct(tmp_path, monkeypatch):
    from hyperpocket_tpu_torch.train import trainer

    losses = trainer._losses

    def half(model, rec, mu, sigma, gt, loss_coef, batch):
        h = rec.shape[0] // 2
        loss, loss_r, loss_k = losses(model, rec[:h], None if mu is None else mu[:h],
                                      None if sigma is None else sigma[:h], gt[:h], loss_coef,
                                      batch // 2)
        return 2 * loss_r + loss_k, 2 * loss_r, loss_k  # the mean over the rest

    monkeypatch.setattr(trainer, "_losses", half)
    root = small_root(tmp_path, "chair_train_fp32", SMALL_TRAIN)
    _, _, line = drive(root, "chair_train_fp32")
    assert not line["correct"], line["checks"]


def test_a_learning_rate_wrong_after_epoch_1_is_not_correct(tmp_path, monkeypatch):
    """A fault that epoch 1 does not show: the window's last epoch does."""
    from hyperpocket_tpu_torch.train import trainer

    schedule = trainer.make_lr_schedule
    monkeypatch.setattr(trainer, "make_lr_schedule", lambda cfg, lr: (
        lambda epoch, first=schedule(cfg, lr): first(epoch) * (1 if epoch == 1 else 2)))
    root = small_root(tmp_path, "chair_train_fp32", SMALL_TRAIN)
    outcome, _, line = drive(root, "chair_train_fp32")
    gaps = {c.name: c for c in outcome.checks}
    assert not line["correct"] and not gaps["wstep1_gap"].ok
    assert all(gaps[k].ok for k in ("loss1_gap", "grad1_gap", "delta3_gap"))


def test_a_val_step_that_leaves_out_half_the_batch_is_not_correct(tmp_path, monkeypatch):
    from hyperpocket_tpu_torch.train import trainer

    make = trainer.make_val_step

    def broken(model, loss_coef, mesh=None):
        step = make(model, loss_coef, mesh)

        def val(existing, missing, gt, generator, epoch, num_points, vae_eps=None,
                ball_points=None):
            loss, rec = step(existing, missing, gt, generator, epoch, num_points, vae_eps,
                             ball_points)
            h = rec.shape[0] // 2  # the mean taken over the first half
            return 2 * trainer.reconstruction_loss(gt[:h], rec[:h], loss_coef), rec
        return val

    monkeypatch.setattr(trainer, "make_val_step", broken)
    root = small_root(tmp_path, "chair_train_fp32", SMALL_TRAIN)
    outcome, _, line = drive(root, "chair_train_fp32")
    assert not line["correct"] and not {c.name: c for c in outcome.checks}["val_gap"].ok


def test_a_new_cell_is_found_by_name_and_nothing_else_is_edited(tmp_path):
    root = small_root(tmp_path, "chair_serve_single_bf16", {})
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in root.rglob("*") if p.is_file()}
    new = json.loads((root / "workloads" / "chair_serve_single_bf16.json").read_text())
    new["params"].update(batch=2, pool_batches=2, sample_calls=2, trace_calls=2)
    new["why"] = "a cell added as a file of its own"
    (root / "workloads" / "chair_serve_pair_bf16.json").write_text(json.dumps(new))
    outcome, metrics, line = drive(root, "chair_serve_pair_bf16", trace=True)
    assert line["correct"] and outcome.counters["batch"] == 2
    assert "serve_clouds_per_s" not in metrics  # a traced run reports the per-layer metrics
    after = {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in before}
    assert after == before
