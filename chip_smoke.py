#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's completion-serving path once on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card::

    python3 chip_smoke.py

Phases, each fatal on any error:

1. device: CUDA must be present; prints the card's name and power limit
   (``nvidia-smi``) and turns TF32 off for fp32 matmuls.
2. build: compiles ``hyperpocket_tpu_torch/csrc/*.cu`` with nvcc (sm_90a).
3. kernel vs plain: the trunk kernel (``ops/trunk_pool.py``) against its
   plain PyTorch version on the card, at the serving shapes and at ragged,
   single-cloud and tied inputs and with layer-5 biases shifted to negative
   maxima, on the served model's weights; max |kernel - plain| <= 2e-2, the JAX
   package's bound for this kernel; both timed with CUDA events.
4. slice: the chair config at full width in bf16, weights from seed 1856
   (every bias drawn anew, distinct per channel, as trained weights have
   them; initialisation zeroes most of them), written as a JAX-layout checkpoint and served through
   ``serving.main(["infer", ...])`` (PLY in, PLY out), then three B=64
   requests through ``make_serving_fn``. The trunk kernel must launch once
   per request; equal seeds give equal outputs, another seed another
   output; the bf16 output is held to the fp32 plain path on the same
   weights and ball points (relative L2 <= 0.1).
5. throughput: bf16 and fp32 completion at B=256 in clouds/s: all clouds
   over all the synchronised time of the timed windows, with each window's
   rate beside it.

``--profile PATH`` adds a phase that writes, for bf16 and fp32 serving at
B=256 and B=64, the wall time per call and the device time per call by
kernel (``torch.profiler``) to PATH as JSON.

The line before the last is a JSON object with the kernel's launches,
error and times; the last line is ``{"ok": true, "device": {...}}``.
Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import collections
import copy
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "settings" / "config_3depn_chair.json"
SEED = 1856
KERNEL_ATOL = 2e-2  # tests/test_pallas_encoder.py: bf16 per-layer rounding
REL_L2_TOL = 0.1
N_EXISTING, N_OUT = 1024, 2048
SERVE_BATCH, BENCH_BATCH = 64, 256


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, windows: int = 5, warmup: int = 3) -> float:
    """Median over windows of the per-call device time, from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def clouds_per_s(fn, batch: int, iters: int = 10, windows: int = 5, warmup: int = 3) -> dict:
    """All clouds over the summed wall time of windows that end in a synchronize.

    Each window's own rate is kept beside the total to show the spread.
    """
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    seconds = []
    for w in range(windows):
        t0 = time.perf_counter()
        for i in range(iters):
            fn(1000 + w * iters + i)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return {"clouds_per_s": batch * iters * windows / sum(seconds),
            "window_clouds_per_s": [batch * iters / s for s in seconds]}


def build_model(compute_dtype: str):
    """The chair config at full width; weights and biases drawn from SEED."""
    from hyperpocket_tpu_torch.models.full_model import FullModel

    config = json.loads(CONFIG.read_text())
    config["full_model"]["compute_dtype"] = compute_dtype
    gen = torch.Generator().manual_seed(SEED)
    model = FullModel.from_config(config["full_model"], gen)
    # initialisation zeroes most biases; trained weights have distinct ones per
    # channel, and only those show a bias read from the wrong channel
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return config, model


def kernel_vs_plain(served, device) -> dict:
    """The trunk kernel vs its plain version on ``served``'s bf16 real encoder."""
    from hyperpocket_tpu_torch.ops.trunk_pool import trunk_pooled, trunk_pooled_reference

    bf16 = torch.bfloat16
    encoder = served.real_encoder
    layers = [(l.weight, l.bias) for l in encoder.conv]
    gen = torch.Generator(device=device).manual_seed(SEED)

    def cloud(b, n):
        return (torch.randn((b, n, 3), generator=gen, device=device) * 0.3).to(bf16)

    check(all(bool((b != b[0]).any()) for _, b in layers), "trunk biases are not distinct")
    # layer 5 has no ReLU: biases shifted by -2 drive the maxima below zero
    # and keep them above -4, where one bf16 step (0.031) exceeds the bound
    negative = [*layers[:4], (layers[4][0], layers[4][1] - 2.0)]
    base = cloud(2, 64)
    ties = torch.cat([base, base], dim=1).contiguous()
    cases = {
        "B256_N1024": (layers, cloud(BENCH_BATCH, N_EXISTING)),
        "B64_N1024": (layers, cloud(SERVE_BATCH, N_EXISTING)),
        "B3_N200": (layers, cloud(3, 200)),
        "B1_N8": (layers, cloud(1, 8)),
        "ties_B2_N128": (layers, ties),
        "negative_B2_N128": (negative, ties),
    }
    errs = {}
    for name, (case_layers, x) in cases.items():
        got = trunk_pooled(case_layers, x)
        torch.cuda.synchronize()
        want = trunk_pooled_reference(case_layers, x)
        check(got.shape == want.shape == (x.shape[0], 512), f"{name}: shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite kernel output")
        errs[name] = (got.float() - want.float()).abs().max().item()
        print(f"kernel vs plain {name}: max_abs_err {errs[name]!r}")
        check(errs[name] <= KERNEL_ATOL, f"{name}: max |kernel - plain| {errs[name]} > {KERNEL_ATOL}")
    check(bool((trunk_pooled_reference(negative, ties).float() < 0).any()),
          "the shifted biases gave no negative maximum")

    times = {}
    for name in ("B256_N1024", "B64_N1024"):
        x = cases[name][1]
        times[name] = {
            "kernel_ms": cuda_ms(lambda: trunk_pooled(layers, x)),
            "plain_ms": cuda_ms(lambda: trunk_pooled_reference(layers, x), iters=5),
            # the same five layers as plain bf16 matmuls (cuBLAS) + max, for context
            "bf16_matmul_chain_ms": cuda_ms(lambda: encoder.conv_stack(x).amax(dim=1), iters=10),
        }
        print(f"trunk timing {name}: {json.dumps(times[name])}")
    return {"max_abs_err": max(errs.values()), "errs": errs, "times": times}


def write_checkpoint(config: dict, model, tmp: Path) -> Path:
    """The model as a JAX-layout checkpoint in a results tree; returns the config path."""
    from hyperpocket_tpu_torch.convert import save_jax_npz
    from hyperpocket_tpu_torch.train.config import get_results_dir_path

    config = copy.deepcopy(config)
    config["results_root"] = str(tmp / "results")
    training_dir = Path(get_results_dir_path(config, "training"))
    (training_dir / "weights").mkdir(parents=True)
    (training_dir / "metrics").mkdir(parents=True)
    save_jax_npz(str(training_dir / "weights" / "00001_model.npz"), model)
    np.save(training_dir / "metrics" / "00001_val.npy", np.array([[1.0]]))
    path = tmp / "config.json"
    path.write_text(json.dumps(config))
    return path


def drive_slice(config: dict, model, model32, device, tmp: Path) -> dict:
    """The main path: infer CLI + three serving requests, with launch counts."""
    from hyperpocket_tpu_torch import serving
    from hyperpocket_tpu_torch.data.plyio import load_ply, save_ply
    from hyperpocket_tpu_torch.ops.sampling import generate_target_network_input_batch
    from hyperpocket_tpu_torch.ops.trunk_pool import trunk_pooled

    cfg_path = write_checkpoint(config, model, tmp)
    rng = np.random.default_rng(SEED)
    plys = []
    for i, n in enumerate((3000, 4096, 2500)):
        p = tmp / f"scan{i}.ply"
        save_ply(p, rng.normal(size=(n, 3)).astype(np.float32) * 0.2 + np.float32(i))
        plys.append(str(p))
    out_dir = tmp / "completions"

    existing = torch.randn((SERVE_BATCH, N_EXISTING, 3),
                           generator=torch.Generator().manual_seed(1)) * 0.3
    noise = torch.randn((SERVE_BATCH, model.get_noise_size()),
                        generator=torch.Generator().manual_seed(2)) * 0.13
    existing, noise = existing.to(device), noise.to(device)

    trunk_pooled.launches = 0
    t0 = time.perf_counter()
    rc = serving.main(["infer", "--config", str(cfg_path), "--inputs", *plys,
                       "--out-dir", str(out_dir), "--samples", "2", "--noise-std", "0.13"])
    check(rc == 0, f"infer exited {rc}")
    infer_launches = trunk_pooled.launches
    f = serving.make_serving_fn(model, num_output_points=N_OUT, device=device)
    outs = [f(existing, noise, seed) for seed in (11, 11, 12)]
    torch.cuda.synchronize()
    launches = trunk_pooled.launches
    slice_s = time.perf_counter() - t0

    written = sorted(out_dir.glob("*.ply"))
    check(len(written) == 6, f"infer wrote {len(written)} PLYs, expected 6")
    for p in written:
        pts = load_ply(p)
        check(pts.shape == (N_OUT, 3) and bool(np.isfinite(pts).all()), f"{p.name}: {pts.shape}")
    for out in outs:
        check(out.shape == (SERVE_BATCH, N_OUT, 3) and out.dtype == torch.float32,
              f"serving output {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out).all()), "non-finite serving output")
    check(torch.equal(outs[0], outs[1]), "the same seed gave different completions")
    check(not torch.equal(outs[0], outs[2]), "another seed gave the same completion")
    check(infer_launches == 1, f"infer launched the trunk kernel {infer_launches} times, not 1")
    check(launches == 4, f"4 requests launched the trunk kernel {launches} times")

    pts = generate_target_network_input_batch(
        model.target_network_input, torch.Generator(device=device).manual_seed(5), 1e9,
        SERVE_BATCH, N_OUT)
    served = model.serving_params().to(device)
    got = served.apply(existing, None, None, 1e9, num_output_points=N_OUT, training=False,
                       noise=noise, ball_points=pts)
    want = model32.to(device).apply(existing, None, None, 1e9, num_output_points=N_OUT,
                                    training=False, noise=noise, ball_points=pts)
    rel_l2 = ((got - want).norm() / want.norm()).item()
    print(f"slice: bf16 vs fp32 plain relative L2 {rel_l2!r} (limit {REL_L2_TOL})")
    check(rel_l2 <= REL_L2_TOL, f"bf16 vs fp32 relative L2 {rel_l2} > {REL_L2_TOL}")
    return {"launches": launches, "infer_launches": infer_launches, "rel_l2": rel_l2,
            "slice_s": slice_s, "plys": len(written)}


def throughput(model, model32, device) -> dict:
    from hyperpocket_tpu_torch import serving

    gen = torch.Generator(device=device).manual_seed(3)
    existing = torch.randn((BENCH_BATCH, N_EXISTING, 3), generator=gen, device=device) * 0.3
    noise = torch.randn((BENCH_BATCH, model.get_noise_size()), generator=gen, device=device) * 0.1
    out = {}
    for name, m in (("bf16", model), ("fp32", model32)):
        f = serving.make_serving_fn(m, num_output_points=N_OUT, device=device)
        rate = clouds_per_s(lambda s: f(existing, noise, s), BENCH_BATCH)
        out[f"{name}_clouds_per_s"] = rate["clouds_per_s"]
        out[f"{name}_window_clouds_per_s"] = rate["window_clouds_per_s"]
    return out


def profile(model, model32, device, path: Path, calls: int = 5) -> dict:
    """Wall time per serving call, and device time per call by kernel (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from hyperpocket_tpu_torch import serving

    gen = torch.Generator(device=device).manual_seed(4)
    report = {}
    for batch in (BENCH_BATCH, SERVE_BATCH):
        existing = torch.randn((batch, N_EXISTING, 3), generator=gen, device=device) * 0.3
        noise = torch.randn((batch, model.get_noise_size()), generator=gen, device=device) * 0.1
        for name, m in (("bf16", model), ("fp32", model32)):
            f = serving.make_serving_fn(m, num_output_points=N_OUT, device=device)
            wall_ms = 1e3 * batch / clouds_per_s(lambda s: f(existing, noise, s), batch,
                                                 iters=20, windows=1)["clouds_per_s"]
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for s in range(calls):
                    f(existing, noise, s)
                torch.cuda.synchronize()
            kernels = collections.Counter()
            for evt in prof.events():
                if evt.device_type == DeviceType.CUDA:
                    kernels[evt.name[:100]] += evt.time_range.elapsed_us() / 1e3 / calls
            check(bool(kernels), f"{name} B={batch}: torch.profiler saw no device time")
            device_ms = sum(kernels.values())
            report[f"{name}_B{batch}"] = {
                "wall_ms": wall_ms, "device_ms": device_ms, "busy": device_ms / wall_ms,
                "kernels_ms": dict(kernels.most_common())}
            print(f"profile {name} B={batch}: wall {wall_ms!r} ms, device {device_ms!r} ms, "
                  f"busy {device_ms / wall_ms!r}")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=1))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=Path, default=None, metavar="PATH",
                    help="also write the per-kernel device time of serving calls to PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke needs a GPU",
              file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    from hyperpocket_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib._name}")

    config, model = build_model("bfloat16")
    model32 = copy.deepcopy(model)
    model32.compute_dtype = "float32"

    kern = kernel_vs_plain(model.serving_params().to(device), device)
    with tempfile.TemporaryDirectory() as tmp:
        sl = drive_slice(config, model, model32, device, Path(tmp))
    print(f"slice: {json.dumps(sl)}")
    tp = throughput(model, model32, device)
    print(f"throughput B={BENCH_BATCH}: {json.dumps(tp)} on {card}")
    if args.profile is not None:
        profile(model, model32, device, args.profile)
        print(f"profile: written to {args.profile}")

    t256 = kern["times"]["B256_N1024"]
    print(card)
    print(json.dumps({"kernels": [{
        "name": "trunk_pool",
        "route": "cuda",
        "source": "hyperpocket_tpu_torch/csrc/trunk_pool.cu",
        "replaces": "hyperpocket_tpu/ops/pallas_encoder.py:198",
        "launches": sl["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": t256["kernel_ms"],
        "plain_ms": t256["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
