"""The benchmark's files against its contract, its counts against hand
counts, and its generators' determinism. CPU only, a few seconds."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, inputs, trace
from benchmark.counts import model as counts

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CHAIR = json.loads((ROOT / "benchmark/configs/hyperpocket_3depn_chair.json").read_text())


def test_names_and_units_hold_only_allowed_characters():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for text in [w["why"] for w in BENCH["workloads"]] + [m.get("layer", "x") for m in metrics]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for kind in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[kind]}) == len(BENCH[kind])
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_every_moves_names_an_end_to_end_metric_its_cells_report():
    reported = {}
    for m in BENCH["end_to_end"]:
        for cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
            reported.setdefault(cell, set()).add(m["name"])
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
            assert m["moves"] in reported[cell], (m["name"], cell)
    for cell in (w["name"] for w in BENCH["workloads"]):
        assert "setup_s" in reported[cell] and len(reported[cell]) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in BENCH["per_layer"])


def test_bounds_and_run_seconds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    chips = [w["chips"] for w in BENCH["workloads"]]
    assert set(chips) <= {1, 4}
    assert sum(c == 4 for c in chips) <= max(1, len(chips) // 4)


def test_every_cell_config_and_metric_has_its_files():
    for w in BENCH["workloads"]:
        workload, config = harness.load_cell(w["name"])
        assert (workload["config"], workload["traffic"], workload["why"], workload["chips"]) == (
            w["config"], w["traffic"], w["why"], w["chips"])
        assert (ROOT / "benchmark" / "traffic" / f"{workload['driver']}.py").exists()
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for m in BENCH["per_layer"]:
        reader = harness.load_module(ROOT / "benchmark" / "metrics" / f"{m['name']}.py")
        assert reader.UNIT == m["unit"]
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1].startswith("benchmark/")


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    files = list((ROOT / "benchmark").rglob("*.py"))
    assert files
    for path in files:
        found = _imports(path) & set(harness.FORBIDDEN)
        assert not found, (path, found)
    for path in (ROOT / "benchmark" / "reference").rglob("*.py"):
        assert "hyperpocket_tpu_torch" not in _imports(path), path
        assert "hyperpocket_tpu_torch" not in path.read_text(), path


def test_loaded_forbidden_compares_the_top_level_name_whole():
    assert harness.loaded_forbidden({"hyperpocket_tpu_torch.serving": 1, "torch": 1}) == []
    assert harness.loaded_forbidden({"jax.numpy": 1, "hyperpocket_tpu.ops": 1, "flax": 1}) == [
        "flax", "hyperpocket_tpu.ops", "jax.numpy"]


def test_counts_match_hand_counts():
    model = CHAIR["settings"]["full_model"]
    trunk = 3 * 64 + 64 * 128 + 128 * 256 + 256 * 512 + 512 * 512  # 434,368 MACs a point
    decode = 3 * 32 + 32 * 64 + 64 * 128 + 128 * 64 + 64 * 3
    assert decode == counts.decode_macs_a_point([32, 64, 128, 64]) == 18720
    flat = (3 + 1) * 32 + (32 + 1) * 64 + (64 + 1) * 128 + (128 + 1) * 64 + (64 + 1) * 3
    assert flat == counts.flat_weight_count([32, 64, 128, 64]) == 19011
    hyper = 256 * 64 + 64 * 128 + 128 * 512 + 512 * 1024 + 1024 * 2048
    serve = 2 * (trunk * 1024 + 512 * 512 + 512 * 128 + hyper + 2048 * 19011 + decode * 2048)
    assert serve == counts.serve_flops_a_cloud(model, 1024, 2048)
    assert abs(serve / 1e9 - 1.05) < 0.005
    # training: both trunks forward on 1024 points; each trunk's backward on its
    # 512 argmax rows (recompute + 2x layers 1-4 + 2 x 512 for the last);
    # every other layer 3x its forward; the Chamfer pairs 3 MACs forward, 6 back
    trunk_bwd = 512 * (trunk + 2 * (trunk - 512 * 512) + 2 * 512)
    dense = hyper + 2048 * 19011 + decode * 2048 + 2 * (512 * 512) + 512 * 128 + 2 * 512 * 128
    train = 2 * (2 * trunk * 1024 + 2 * trunk_bwd + 3 * dense + 9 * 2048 * 2048)
    assert train == counts.train_flops_a_cloud(model, 1024, 1024, 2048)
    # the kernels' least times at the main path's shapes (PERF.md's bounds)
    assert abs(counts.k4_trunk_bound_s(256, 1024) * 1e3 - 0.232) < 0.001
    assert abs(counts.k10_decode_bound_s(256, 2048, [32, 64, 128, 64], "bfloat16") * 1e3
               - 0.0198) < 0.0005
    assert abs(counts.k10_decode_bound_s(256, 2048, [32, 64, 128, 64], "float32") * 1e3
               - 0.293) < 0.001
    assert abs(counts.k9_chamfer_bound_s(64, 2048, 2048) * 1e3 - 0.112) < 0.001


def test_generators_are_deterministic_from_their_seeds():
    model = CHAIR["settings"]["full_model"]
    a = inputs.make_weights(model, 2**31 + 11, "cpu")
    b = inputs.make_weights(model, 2**31 + 11, "cpu")
    c = inputs.make_weights(model, 2**31 + 12, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["hyper_network.heads.weight"], c["hyper_network.heads.weight"])
    scans = [inputs.make_scans(torch.Generator().manual_seed(s), 3, 256, 128) for s in (5, 5, 6)]
    assert all(torch.equal(x, y) for x, y in zip(scans[0], scans[1]))
    assert not torch.equal(scans[0][1], scans[2][1])
    one = inputs.corpus_arrays(4, 2, 64, 32, 9)
    two = inputs.corpus_arrays(4, 2, 64, 32, 9)
    assert all(np.array_equal(x, y) for x, y in zip(one, two))
    assert harness.sub_seed(2**31 + 3, "x") == harness.sub_seed(2**31 + 3, "x") != \
        harness.sub_seed(2**31 + 3, "y")


def test_the_corpus_tree_reads_back_through_the_dataset(tmp_path):
    from hyperpocket_tpu_torch.data.shapenet_3depn import ShapeNet3DEPNDataset

    spec = {"shapes": 3, "samples": 2, "n_gt": 64, "n_partial": 32, "corpus_seed": 4}
    path = inputs.ensure_corpus(tmp_path, spec)
    assert inputs.ensure_corpus(tmp_path, spec) == path
    gt, ex, mi = inputs.corpus_arrays(3, 2, 64, 32, 4)
    ds = ShapeNet3DEPNDataset(str(path), "train", ["03001627"], num_samples=2)
    assert len(ds) == 6
    for i in range(6):
        e, m, g, _ = ds[i]
        assert np.array_equal(e, ex[i // 2, i % 2]) and np.array_equal(m, mi[i // 2, i % 2])
        assert np.array_equal(g, gt[i // 2])


def test_trace_summary_unions_device_time_and_names_gaps():
    def x(name, cat, ts, dur, tid=1):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": tid}

    events = [x(trace.WINDOW, "user_annotation", 0, 100),
              x("call", "user_annotation", 10, 80), x("cudaMemcpyAsync", "cuda_runtime", 40, 30),
              x("k1", "kernel", 5, 20, 7), x("k1", "kernel", 15, 20, 8),
              x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 50, 10, 7),
              x("k2", "kernel", 95, 20, 7)]
    s = trace.summarize(events)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx((30 + 10 + 5) * 1e-6)
    assert s.kernels["k1"] == [2, pytest.approx(40e-6)] and s.copies["HtoD"][0] == 1
    gaps = dict(s.idle_gaps)
    assert gaps["cudaMemcpyAsync"] == pytest.approx(15e-6)  # 35..50, inside the copy call
    assert gaps["call"] == pytest.approx(35e-6)  # 60..95
    assert gaps[trace.WINDOW] == pytest.approx(5e-6)  # 0..5
