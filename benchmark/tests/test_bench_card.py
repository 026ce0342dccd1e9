"""The command on the card: one short run of a cell, untraced and traced.
Marked ``cuda``; skips without a card (decided in the fixture)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def run_cell(cell: str, trace: int) -> dict:
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                           str(2**31 + 101), "--seconds", "2", "--trace", str(trace)],
                          cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    assert proc.stderr.strip().splitlines()[-1].startswith("check rel_gap:")
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_serving_cell_runs_on_the_card(card, trace):
    line = run_cell("c3d_serve_submit_fp32", trace)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    names = {"setup_s", "serve_clouds_per_s"} if not trace else {
        "device_idle_pct.serve", "mfu.serve", "k10_decode_roofline", "serve.copy_ms_per_call"}
    assert set(line["metrics"]) == names
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert len(line["breakdown"]["device_ops"]) <= 10
