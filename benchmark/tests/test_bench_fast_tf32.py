"""The TF32 training cell ``chair_train_fast_tf32``: its configuration and
workload against the contract and the published settings, ``mfu.train_tf32``
beside ``mfu.train`` and ``mfu.train_bf16`` on the three training cells'
counters, and on the CPU at a small size its run through
``traffic/train_epochs_tf32.py``, the bf16-operand control and the planted
faults: the switch not taken, half a batch out of the loss, and a program
that does not count its epochs' dtype (as a program whose epoch routine
does not cross the switch). About a minute and a half."""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness, trace
from benchmark.counts import peaks, tf32
from benchmark.tests.test_bench_cpu import SMALL_TRAIN, TRAIN_SETTINGS, drive, make_run, small_root

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "chair_train_fast_tf32"
CONFIG = "hyperpocket_3depn_chair_fast_tf32"
EPOCH1 = {"loss1_gap", "grad1_gap", "delta3_gap"}
WINDOW = {"wstep1_gap", "wstep1_adam_gap"}
VAL1 = {"val1_gap", "rec1_tf32_ratio"}  # epoch 1's val, whatever the window
CHECKS = EPOCH1 | WINDOW | VAL1 | {"bf16_epochs"}
MFU = ("mfu.train", "mfu.train_bf16", "mfu.train_tf32")


def _flat(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def reader(name: str):
    return harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py")


def test_the_configuration_is_the_published_fast_settings_but_for_its_reduced_keys():
    entry = next(c for c in BENCH["configs"] if c["name"] == CONFIG)
    config = json.loads((ROOT / entry["file"]).read_text())
    assert "settings/config_3depn_chair_fast.json" in config["source_settings"]
    published = _flat(json.loads((ROOT / "settings/config_3depn_chair_fast.json").read_text()))
    run = _flat(config["settings"])
    changed = {k for k in set(published) | set(run) if published.get(k) != run.get(k)}
    assert changed <= set(entry["reduced"]), changed - set(entry["reduced"])
    assert set(entry["reduced"]) == set(config["reduced"])
    assert "training.compute_dtype_switch.epoch" in changed
    assert (published["training.compute_dtype_switch.epoch"],
            run["training.compute_dtype_switch.epoch"]) == (50, 0)
    assert (run["training.compute_dtype"], run["training.compute_dtype_switch.compute_dtype"],
            run["training.optimizer.hyperparams.moment_dtype"],
            run["training.matmul_precision"]) == ("bfloat16", "float32", "bfloat16", "high")
    fast = json.loads((ROOT / "benchmark/configs/hyperpocket_3depn_chair_fast.json").read_text())
    assert config["settings"]["full_model"] == fast["settings"]["full_model"]  # the widths
    assert config["assumed"] == fast["assumed"]
    assert set(config["reduced"]) == set(fast["reduced"])
    # the same keys as the fast configuration, so its source names the phase it stands for
    assert config["source"] == entry["source"]
    assert entry["source"].startswith("https://arxiv.org/abs/2102.05973 ")
    assert "compute_dtype_switch" in entry["source"] and len(entry["source"]) <= 200
    others = {(c["source"], frozenset(c["reduced"])) for c in BENCH["configs"] if c is not entry}
    assert (entry["source"], frozenset(entry["reduced"])) not in others


def test_the_cell_shares_the_fp32_cells_corpus_and_lists_its_metrics():
    workload, _ = harness.load_cell(CELL)
    fp32, _ = harness.load_cell("chair_train_fp32")
    assert workload["params"]["corpus"] == fp32["params"]["corpus"]
    assert (workload["driver"], workload["chips"], workload["config"]) == (
        "train_epochs_tf32", 1, CONFIG)
    assert set(workload["params"]["limits"]) == CHECKS
    assert workload["params"]["limits"]["bf16_epochs"] == 0
    listed = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]
              if CELL in m.get("workloads", [])}
    assert listed == {"train_clouds_per_s", "device_idle_pct.train", "k9_chamfer_roofline",
                      "train.collect_ms_per_epoch",
                      "train.loader_wait_ms_per_epoch", "train.loader_busy_ms_per_epoch",
                      "mfu.train_tf32"}
    (entry,) = [m for m in BENCH["per_layer"] if m["name"] == "mfu.train_tf32"]
    assert (entry["workloads"], entry["moves"], entry["unit"]) == ([CELL], "train_clouds_per_s",
                                                                   "%")
    assert reader("mfu.train_tf32").UNIT == "%"


def test_the_tf32_peak_is_half_the_data_sheets_sparse_rate():
    assert tf32.TF32_FLOPS == 494.7e12
    assert tf32.TF32_FLOPS == pytest.approx(989.4e12 / 2)
    assert peaks.FP32_FLOPS < tf32.TF32_FLOPS < peaks.BF16_FLOPS


SUMMARY = trace.Summary(window_s=2.0, busy_s=1.8, kernels={}, copies={}, device_ops=[],
                        idle_gaps=[])
BASE = {"kind": "train", "steps": 128, "batch": 64, "n_gt": 2048, "n_partial": 1024,
        "flops": 3.0e13}
CELL_COUNTERS = {  # what each training cell's driver hands the readers
    "chair_train_fp32": dict(BASE, epochs=2),
    "chair_train_fast_bf16": dict(BASE, window_epochs=2, compute_dtype="bfloat16"),
    CELL: dict(BASE, window_epochs=2, compute_dtype="float32", matmul_precision="high"),
}
READS = {"mfu.train": "chair_train_fp32", "mfu.train_bf16": "chair_train_fast_bf16",
         "mfu.train_tf32": CELL}


@pytest.mark.parametrize("cell", sorted(CELL_COUNTERS))
def test_each_mfu_reads_its_own_training_cell_alone(cell):
    for name in MFU:
        value = reader(name).read(SUMMARY, CELL_COUNTERS[cell])
        assert (value is not None) == (READS[name] == cell), (name, cell, value)
    if cell == CELL:
        assert reader("mfu.train_tf32").read(SUMMARY, CELL_COUNTERS[cell]) == pytest.approx(
            100 * 3.0e13 / 2.0 / 494.7e12)


def test_mfu_train_tf32_reads_nothing_without_tf32_or_a_trace():
    mfu = reader("mfu.train_tf32")
    counters = CELL_COUNTERS[CELL]
    assert mfu.read(None, counters) is None
    assert mfu.read(SUMMARY, dict(counters, kind="serve")) is None
    assert mfu.read(SUMMARY, dict(counters, matmul_precision="highest")) is None
    assert mfu.read(SUMMARY, dict(counters, compute_dtype="bfloat16")) is None
    idle = trace.Summary(window_s=2.0, busy_s=0.0, kernels={}, copies={}, device_ops=[],
                         idle_gaps=[])
    assert mfu.read(idle, counters) is None  # no device time: a CPU run


def test_the_control_rounds_operands_to_bf16():
    driver = harness.load_module(ROOT / "benchmark" / "traffic" / "train_epochs_tf32.py")
    x = torch.tensor([1.0 + 2.0 ** -9, 1.0 + 3 * 2.0 ** -9, -3.0, 1e-3])
    assert torch.equal(driver.bf16(x), x.to(torch.bfloat16).float())
    assert driver.bf16(x)[0] == 1.0 and driver.bf16(x).dtype == torch.float32


# ---------------------------------------------------------------------------
# The cell on the CPU at a small size


def tf32_root(tmp: Path, params: dict = SMALL_TRAIN) -> Path:
    root = small_root(tmp, CELL, params)
    path = root / "configs" / f"{CONFIG}.json"
    cfg = json.loads(path.read_text())
    for split, over in TRAIN_SETTINGS.items():
        cfg["settings"]["training"]["dataloader"][split].update(over)
    path.write_text(json.dumps(cfg))
    return root


def test_the_cell_agrees_with_the_reference_and_reads_the_programs_precision(tmp_path):
    outcome, metrics, line = drive(tf32_root(tmp_path), CELL, trace=True)
    assert line["correct"], line["checks"]
    assert {c.name for c in outcome.checks} == CHECKS
    assert line["checks"]["bf16_epochs"]["value"] == 0
    counters = outcome.counters
    assert "epochs" not in counters and counters["window_epochs"] >= 1
    assert (counters["compute_dtype"], counters["matmul_precision"]) == ("float32", "high")
    assert not set(MFU) & set(metrics)  # no device time on the CPU


def test_the_bf16_control_and_a_half_batch_fail_a_limit(tmp_path):
    """bf16 operands fail a number of epoch 1's val; in the numbers of its
    first steps and of the window's last epoch their gaps overlap the TF32
    program's (PERF.md §2). The half batch fails a number of epoch 1's
    steps and the worst val step. A control runs the reference's own
    Adam, so it reports no ``wstep1_adam_gap``."""
    root = tf32_root(tmp_path)
    run = make_run(root, CELL)
    driver = harness.load_module(root / "traffic" / "train_epochs_tf32.py")
    outcome = driver.run(run, variants=[("bf16", driver.bf16, None),
                                        ("half_batch", None, slice(0, 4))])
    limits = run.params["limits"]
    assert all(c.ok for c in outcome.checks), outcome.checks
    for name, gaps in outcome.counters["variants"].items():
        failed = {k for k in limits if gaps.get(k, 0.0) > limits[k]}
        if name == "bf16":
            assert failed & VAL1, (name, gaps)
        else:
            assert failed & EPOCH1 and "val1_gap" in failed, (name, gaps)
            assert gaps["rec1_tf32_ratio"] == 0.0  # the clouds it leaves in are whole


def test_epoch_1s_val_numbers_read_the_same_whatever_the_window(tmp_path):
    """A longer window (a faster program) moves the window's last epoch,
    not the state epoch 1's val is read from: one window epoch against two
    (a traced run stops after ``trace_epochs``, whatever the time)."""
    root = tf32_root(tmp_path, dict(SMALL_TRAIN, trace_epochs=2))
    driver = harness.load_module(root / "traffic" / "train_epochs_tf32.py")
    workload, config = harness.load_cell(CELL, root)
    outcomes = [driver.run(harness.Run(CELL, workload, config, 2**31 + 29, seconds, trace,
                                       torch.device("cpu"), time.perf_counter(), root))
                for seconds, trace in ((0.0, False), (600.0, True))]
    assert [o.counters["window_epochs"] for o in outcomes] == [1, 2]
    first, longer = ({c.name: c.value for c in o.checks if c.name in VAL1} for o in outcomes)
    assert first == longer and set(first) == VAL1


def test_the_switch_not_taken_is_not_correct(tmp_path, monkeypatch):
    """The program left in bf16: every epoch counted under bfloat16."""
    from hyperpocket_tpu_torch.train import trainer

    monkeypatch.setattr(trainer.Trainer, "_maybe_switch_dtype", lambda self, epoch: None)
    outcome, _, line = drive(tf32_root(tmp_path), CELL)
    assert not line["correct"]
    checks = {c.name: c for c in outcome.checks}
    assert checks["bf16_epochs"].value == 1 + outcome.counters["window_epochs"]
    assert outcome.counters["compute_dtype"] == "bfloat16"


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
    _, _, line = drive(tf32_root(tmp_path), CELL)
    assert not line["correct"], line["checks"]


def test_a_program_that_counts_no_epochs_dtype_stops_after_set_up(tmp_path, monkeypatch):
    """A program whose epoch routine neither crosses the switch nor counts
    its dtype (as one that crosses it only in ``Trainer.run``) cannot run
    the cell: the run ends with an error after set-up's epoch 1."""
    from hyperpocket_tpu_torch.utils import profiling

    tally = profiling.tally
    monkeypatch.setattr(profiling, "tally", lambda name, value=1: None if name.startswith(
        "trainer.compute_dtype.") else tally(name, value))
    with pytest.raises(RuntimeError, match="trainer.compute_dtype"):
        drive(tf32_root(tmp_path), CELL)
