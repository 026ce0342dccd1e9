"""The bf16 training cell ``chair_train_fast_bf16``: its configuration and
workload against the contract and the published settings, its three
per-layer readers against hand counts on a synthetic trace, ``mfu.train``'s
silence on its counters, and on the CPU at a small size its run through
``traffic/train_epochs_bf16.py``, the fp8 control and the planted faults.
About four minutes."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmark import harness, trace
from benchmark.counts import fast_recipe, peaks
from benchmark.reference import quant
from benchmark.tests.test_bench_cpu import SMALL_TRAIN, TRAIN_SETTINGS, drive, make_run, small_root

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "chair_train_fast_bf16"
NEW = ("mfu.train_bf16", "k8_trunk_argmax_roofline", "adam_lowp_roofline")
EPOCH1 = {"loss1_gap", "grad1_gap", "delta3_gap"}
WINDOW = {"wloss1_gap", "wgrad1_gap", "wstep1_gap", "wstep1_adam_gap", "val_gap"}


def _flat(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def reader(name: str):
    return harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py")


def test_the_configuration_is_the_published_fast_settings_but_for_its_reduced_keys():
    entry = next(c for c in BENCH["configs"] if c["name"] == "hyperpocket_3depn_chair_fast")
    config = json.loads((ROOT / entry["file"]).read_text())
    published = _flat(json.loads((ROOT / "settings/config_3depn_chair_fast.json").read_text()))
    run = _flat(config["settings"])
    changed = {k for k in set(published) | set(run) if published.get(k) != run.get(k)}
    assert changed <= set(entry["reduced"]), changed - set(entry["reduced"])
    assert set(entry["reduced"]) == set(config["reduced"])
    assert run["training.compute_dtype_switch.epoch"] == run["training.max_epoch"] == 400
    assert (run["training.compute_dtype"], run["training.optimizer.hyperparams.moment_dtype"],
            run["training.matmul_precision"]) == ("bfloat16", "bfloat16", "high")
    chair = json.loads((ROOT / "benchmark/configs/hyperpocket_3depn_chair.json").read_text())
    assert config["settings"]["full_model"] == chair["settings"]["full_model"]  # the widths


def test_the_cell_shares_the_fp32_cells_corpus_and_lists_its_metrics():
    workload, _ = harness.load_cell(CELL)
    fp32, _ = harness.load_cell("chair_train_fp32")
    assert workload["params"]["corpus"] == fp32["params"]["corpus"]
    assert workload["driver"] == "train_epochs_bf16" and workload["chips"] == 1
    assert set(workload["params"]["limits"]) == EPOCH1 | WINDOW
    listed = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]
              if CELL in m.get("workloads", [])}
    assert listed == {"train_clouds_per_s", "device_idle_pct.train", "k9_chamfer_roofline",
                      "train.capture_ms_per_epoch", "train.collect_ms_per_epoch",
                      "train.loader_wait_ms_per_epoch", "train.loader_busy_ms_per_epoch", *NEW}
    for m in BENCH["per_layer"]:
        if m["name"] in NEW:
            assert (m["workloads"], m["moves"], m["unit"]) == ([CELL], "train_clouds_per_s", "%")
            assert reader(m["name"]).UNIT == "%"


def test_the_kernel_bounds_match_hand_counts():
    rows = 64 * 1024
    tensor_cores = 2 * rows * (64 * 128 + 128 * 256 + 256 * 512 + 512 * 512) / 989e12
    layer_one = 2 * rows * 3 * 64 / 67e12
    assert fast_recipe.k8_trunk_bound_s(64, 1024) == pytest.approx(tensor_cores + layer_one)
    assert abs(fast_recipe.k8_trunk_bound_s(64, 1024) * 1e3 - 0.058) < 0.0005
    assert fast_recipe.adam_lowp_bytes_a_value() == 4 + 4 + 4 + 2 * 2 + 2 * 2 == 20
    # a step of the chair model's 43.3 M trainable values: 0.259 ms (PERF.md)
    assert abs(fast_recipe.adam_lowp_bound_s(43.3e6) * 1e3 - 0.2585) < 0.001


def _summary(window_s: float = 2.0) -> trace.Summary:
    kernels = {
        "void (anonymous namespace)::trunk_pool_kernel<true>(Params)": [8, 0.9e-3],
        "void (anonymous namespace)::trunk_pool_kernel<false>(Params)": [4, 0.5e-3],
        "(anonymous namespace)::fill_zero_keys(unsigned long long*, int)": [8, 0.02e-3],
        "(anonymous namespace)::unpack_keys(unsigned long long const*, __nv_bfloat16*, int*, "
        "int)": [8, 0.03e-3],
        "(anonymous namespace)::fill_neg_inf(float*, int)": [4, 0.01e-3],
        "void (anonymous namespace)::adam_lowp_kernel<float, __nv_bfloat16>(float*, float "
        "const*, __nv_bfloat16*, __nv_bfloat16*, float const*, float const*, Scalars, long "
        "long)": [42 * 128, 0.05],
    }
    return trace.Summary(window_s=window_s, busy_s=1.5, kernels=kernels, copies={},
                         device_ops=[], idle_gaps=[])


COUNTERS = {"kind": "train", "window_epochs": 2, "steps": 128, "batch": 64, "n_gt": 2048,
            "n_partial": 1024, "flops": 3.0e13, "compute_dtype": "bfloat16"}


@pytest.fixture
def totals():
    from hyperpocket_tpu_torch.utils import profiling

    profiling.reset()
    yield profiling
    profiling.reset()


def test_the_readers_against_hand_counts_on_a_synthetic_trace(totals):
    s = _summary()
    k8 = reader("k8_trunk_argmax_roofline").read(s, COUNTERS)
    # K4's launches (trunk_pool_kernel<false>, fill_neg_inf) are left out
    assert k8 == pytest.approx(100 * 8 * fast_recipe.k8_trunk_bound_s(64, 1024) / 0.95e-3)
    assert reader("mfu.train_bf16").read(s, COUNTERS) == pytest.approx(
        100 * 3.0e13 / 2.0 / peaks.BF16_FLOPS)
    adam = reader("adam_lowp_roofline")
    assert adam.read(s, COUNTERS) is None  # no counter: a program that lacks it
    values = 43_300_000
    totals.count("adam_lowp.values", values * COUNTERS["window_epochs"])  # one capture an epoch
    assert adam.read(s, COUNTERS) == pytest.approx(100 * 20 * values * 128 / 3.35e12 / 0.05)
    for name in NEW:
        assert reader(name).read(None, COUNTERS) is None
        assert reader(name).read(s, dict(COUNTERS, kind="serve")) is None


def test_mfu_train_reads_nothing_on_the_bf16_drivers_counters_and_the_reverse():
    s = _summary()
    assert reader("mfu.train").read(s, COUNTERS) is None
    fp32 = {k: v for k, v in COUNTERS.items() if k not in ("window_epochs", "compute_dtype")}
    fp32["epochs"] = 2
    assert reader("mfu.train").read(s, fp32) is not None
    assert reader("mfu.train_bf16").read(s, fp32) is None


# ---------------------------------------------------------------------------
# The cell on the CPU at a small size


def fast_root(tmp: Path) -> Path:
    root = small_root(tmp, CELL, SMALL_TRAIN)
    path = root / "configs" / "hyperpocket_3depn_chair_fast.json"
    cfg = json.loads(path.read_text())
    for split, over in TRAIN_SETTINGS.items():
        cfg["settings"]["training"]["dataloader"][split].update(over)
    path.write_text(json.dumps(cfg))
    return root


def test_the_cell_agrees_with_the_reference_and_counts_window_epochs(tmp_path):
    outcome, metrics, line = drive(fast_root(tmp_path), CELL, trace=True)
    assert line["correct"], line["checks"]
    assert {c.name for c in outcome.checks} == EPOCH1 | WINDOW
    counters = outcome.counters
    assert "epochs" not in counters and counters["window_epochs"] >= 1
    assert counters["compute_dtype"] == "bfloat16"
    assert "mfu.train" not in metrics and "mfu.train_bf16" not in metrics  # no device time


def test_the_fp8_control_and_a_half_batch_fail_a_limit(tmp_path):
    """The half batch fails a number of epoch 1 and one of the window's last
    epoch. fp8 fails one of the window's: in epoch 1 its gaps lie near the
    bf16 program's (PERF.md §2), past it they grow. A control runs the
    reference's own Adam, so it reports no ``wstep1_adam_gap``."""
    root = fast_root(tmp_path)
    run = make_run(root, CELL)
    driver = harness.load_module(root / "traffic" / "train_epochs_bf16.py")
    outcome = driver.run(run, variants=[("fp8", quant.fp8, None),
                                        ("half_batch", None, slice(0, 4))])
    limits = run.params["limits"]
    assert all(c.ok for c in outcome.checks), outcome.checks
    for name, gaps in outcome.counters["variants"].items():
        failed = {k for k in limits if gaps.get(k, 0.0) > limits[k]}  # no Adam gap: not the program's
        assert failed & WINDOW, (name, gaps)
        if name == "half_batch":
            assert failed & EPOCH1, (name, gaps)


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(tmp_path, monkeypatch):
    from hyperpocket_tpu_torch.train import optim

    monkeypatch.setattr(optim.AdamLowp, "step", lambda self, closure=None: None)
    outcome, _, line = drive(fast_root(tmp_path), CELL)
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
    _, _, line = drive(fast_root(tmp_path), CELL)
    assert not line["correct"], line["checks"]


def test_a_learning_rate_wrong_after_epoch_1_is_not_correct(tmp_path, monkeypatch):
    """A fault that epoch 1 does not show: the window's last epoch does."""
    from hyperpocket_tpu_torch.train import trainer

    schedule = trainer.make_lr_schedule
    monkeypatch.setattr(trainer, "make_lr_schedule", lambda cfg, lr: (
        lambda epoch, first=schedule(cfg, lr): first(epoch) * (1 if epoch == 1 else 2)))
    outcome, _, line = drive(fast_root(tmp_path), CELL)
    gaps = {c.name: c for c in outcome.checks}
    assert not line["correct"] and not gaps["wstep1_adam_gap"].ok
    assert gaps["wstep1_adam_gap"].value == pytest.approx(1.0, abs=0.05)
    assert all(gaps[k].ok for k in EPOCH1)


def test_the_adam_gap_compares_the_step_value_by_value_over_the_moved_leaves():
    driver = harness.load_module(ROOT / "benchmark" / "traffic" / "train_epochs_bf16.py")
    expected = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([0.0, 1.0]),
                "c": torch.tensor([6.0, 8.0])}
    step = {n: t.clone() for n, t in expected.items()}
    assert driver.adam_step_gap(step, expected, ["a", "b", "c"]) == 0.0
    step["a"] = torch.tensor([4.0, 3.0])  # the same norm, another direction
    assert driver.adam_step_gap(step, expected, ["a", "b", "c"]) == pytest.approx(2 ** 0.5 / 5)
    step["a"] = expected["a"].clone()
    step["b"] = torch.tensor([0.0, 6.0])  # under the median leaf's norm (5): the median divides
    assert driver.adam_step_gap(step, expected, ["a", "b", "c"]) == pytest.approx(1.0)
    assert driver.adam_step_gap(step, expected, ["a", "c"]) == 0.0  # "b" not compared


def test_the_reference_resumes_from_the_moments_widened_to_fp32(monkeypatch):
    """The program's bf16 moments reach the reference's Adam as fp32 copies."""
    from benchmark.traffic import train_epochs

    driver = harness.load_module(ROOT / "benchmark" / "traffic" / "train_epochs_bf16.py")
    seen = {}

    def follow(run, config, weights, state=None, q=None, rows=None):
        seen["dtypes"] = {t.dtype for d in (state["m"], state["v"]) for t in d.values()}
        return {}

    def fake_run(run, variants=()):
        train_epochs.follow(run, {}, {}, {"m": {"a": torch.ones(2, dtype=torch.bfloat16)},
                                          "v": {"a": torch.ones(2, dtype=torch.bfloat16)}})
        return harness.Outcome(1, 0, {}, [], 0, {"kind": "train", "epochs": 3})

    monkeypatch.setattr(train_epochs, "follow", follow)
    monkeypatch.setattr(train_epochs, "run", fake_run)
    run = make_run(ROOT / "benchmark", CELL)
    outcome = driver.run(run)
    assert seen["dtypes"] == {torch.float32}
    assert outcome.counters == {"kind": "train", "window_epochs": 3,
                                "compute_dtype": "bfloat16"}
    assert train_epochs.follow is follow  # put back
