#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths once on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card::

    python3 chip_smoke.py

Phases, each fatal on any error:

1. device: CUDA must be present; prints the card's name and power limit
   (``nvidia-smi``) and turns TF32 off for fp32 matmuls and cuDNN.
2. build: compiles ``hyperpocket_tpu_torch/csrc/*.cu`` with nvcc (sm_90a),
   one nvcc per source, all started together.
3. trunk kernel vs plain: the trunk kernel (``ops/trunk_pool.py``) against its
   plain PyTorch version on the card, at the serving shapes and at ragged,
   single-cloud and tied inputs and with layer-5 biases shifted to negative
   maxima, on the served model's weights; max |kernel - plain| <= 2e-2, the JAX
   package's bound for this kernel; both timed with CUDA events.
4. serving slice: the chair config at full width in bf16, weights from seed 1856
   (every bias drawn anew, distinct per channel, as trained weights have
   them; initialisation zeroes most of them), written as a JAX-layout checkpoint and served through
   ``serving.main(["infer", ...])`` (PLY in, PLY out), then three B=64
   requests through ``make_serving_fn``. The trunk kernel must launch once
   per request; equal seeds give equal outputs, another seed another
   output; the bf16 output is held to the fp32 plain path on the same
   weights and ball points (relative L2 <= 0.1).
5. serving throughput: bf16 and fp32 completion at B=256 in clouds/s: all
   clouds over all the synchronised time of the timed windows, with each
   window's rate beside it.
6. NN kernels vs plain: K1 (``nn_one_direction``) and K3 (``nn_min_fused``,
   ``ops/nn.py``) against their plain versions at B=64 and B=60 with
   N=M=2048, ragged clouds (B=3, N=200, M=136), more keys than one staged
   chunk (M=4500), duplicated keys (ties) and clouds whose points are all
   equal, in both directions: K1's indices equal, distances within
   1e-6; each kernel and plain version timed with CUDA events at B=64.
7. Chamfer value and gradient at B=64, N=M=2048: the streaming loss (K1
   twice, the gather/scatter backward) against the plain
   ``ops/chamfer.py::chamfer_loss`` under autograd: value within 1e-5
   relative; where the two pick different argmins, the two keys must be a
   near tie (exact distances within 1e-6), and every point no such flip
   touches has its gradient within 5e-3; both timed.
8. training slice: the chair config at full width, the same weights, Adam
   and ``loss_coef`` from the config, B=64 (existing and missing 1024 points,
   gt 2048). fp32: the first step's gradients through the kernels against
   the plain Chamfer's on the same injected noise and ball points (relative
   L2 <= 1e-3), then 5 train steps (K1 twice per step) and a val step at
   B=60 (K3 once); bf16: 3 train steps and a val step (K4 twice, K3 once).
   Losses finite, parameters changed; train and val step times at B=64.

``--profile PATH`` adds a phase that writes, for bf16 and fp32 serving at
B=256 and B=64 and one fp32 and one bf16 train step at B=64, the wall time
per call and the device time per call by kernel (``torch.profiler``) to
PATH as JSON.

The line before the last is a JSON object with the kernels' launches on
their paths, errors and times; the last line is ``{"ok": true, "device":
{...}}``. Nothing of JAX is imported.
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
NN_ATOL = 1e-6  # K1/K3 vs plain: the same arithmetic, the same bits
CHAMFER_RTOL = 1e-5  # the fp32 parity budget
CHAMFER_GRAD_ATOL = 5e-3  # tests/test_pallas_nn.py: argmin near-ties
NEAR_TIE = 1e-6  # the plain loss's expansion rounds distances by ~1e-7 here
STEP_GRAD_REL_L2 = 1e-3
N_EXISTING, N_OUT = 1024, 2048
SERVE_BATCH, BENCH_BATCH = 64, 256
TRAIN_BATCH, VAL_BATCH = 64, 60


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


def step_ms(fn, iters: int = 5, windows: int = 3, warmup: int = 2) -> dict:
    """Wall ms per call over windows that end in a synchronize, with each window's."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    seconds = []
    for w in range(windows):
        t0 = time.perf_counter()
        for i in range(iters):
            fn(100 + w * iters + i)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return {"ms": 1e3 * sum(seconds) / (iters * windows),
            "window_ms": [1e3 * s / iters for s in seconds]}


def nn_kernels_vs_plain(device) -> dict:
    """K1 and K3 vs their plain versions; both timed at B=64, N=M=2048."""
    from hyperpocket_tpu_torch.ops.nn import (
        nn_min_fused,
        nn_min_fused_reference,
        nn_one_direction,
        nn_one_direction_reference,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 1)

    def cloud(b, n):
        return torch.randn((b, n, 3), generator=gen, device=device) * 0.3

    keys = cloud(2, 64)
    cases = {
        "B64_2048": (cloud(TRAIN_BATCH, N_OUT), cloud(TRAIN_BATCH, N_OUT)),
        "B60_2048": (cloud(VAL_BATCH, N_OUT), cloud(VAL_BATCH, N_OUT)),
        "ragged_B3_200x136": (cloud(3, 200), cloud(3, 136)),
        # more keys than one shared-memory chunk (2048)
        "long_keys_B2_300x4500": (cloud(2, 300), cloud(2, 4500)),
        # every key twice, 64 points apart: exact ties, the first index wins
        "ties_B2_256x128": (cloud(2, 256), torch.cat([keys, keys], dim=1).contiguous()),
        "equal_points_B2_128x96": (cloud(2, 1).expand(2, 128, 3).contiguous(),
                                   cloud(2, 1).expand(2, 96, 3).contiguous()),
    }
    errs = {"nn_one_direction": 0.0, "nn_min_fused": 0.0}
    for name, (q, k) in cases.items():
        for a, b in ((q, k), (k, q)):
            dist, idx = nn_one_direction(a, b)
            torch.cuda.synchronize()
            want_d, want_i = nn_one_direction_reference(a, b)
            check(torch.equal(idx, want_i),
                  f"{name}: K1 indices differ from the plain version's at "
                  f"{int((idx != want_i).sum())} queries")
            err = (dist - want_d).abs().max().item()
            check(err <= NN_ATOL, f"{name}: K1 max |kernel - plain| {err} > {NN_ATOL}")
            errs["nn_one_direction"] = max(errs["nn_one_direction"], err)
            if name.startswith("ties") and a is q:
                check(int(idx.max()) < 64, f"{name}: a tie did not go to the first index")
        d1, d2 = nn_min_fused(q, k)
        torch.cuda.synchronize()
        w1, w2 = nn_min_fused_reference(q, k)
        err = max((d1 - w1).abs().max().item(), (d2 - w2).abs().max().item())
        check(err <= NN_ATOL, f"{name}: K3 max |kernel - plain| {err} > {NN_ATOL}")
        errs["nn_min_fused"] = max(errs["nn_min_fused"], err)
        print(f"nn kernels vs plain {name}: K1 indices equal, K1/K3 max_abs_err "
              f"{errs['nn_one_direction']!r} / {err!r}")
    q, k = cases["B64_2048"]
    times = {
        "nn_one_direction": {"ms": cuda_ms(lambda: nn_one_direction(q, k)),
                             "plain_ms": cuda_ms(lambda: nn_one_direction_reference(q, k),
                                                 iters=3)},
        "nn_min_fused": {"ms": cuda_ms(lambda: nn_min_fused(q, k)),
                         "plain_ms": cuda_ms(lambda: nn_min_fused_reference(q, k), iters=3)},
    }
    print(f"nn kernel timing B=64 N=M=2048: {json.dumps(times)}")
    return {"errs": errs, "times": times}


def chamfer_vs_plain(device) -> dict:
    """The streaming Chamfer (K1 + the gather/scatter backward) vs the plain autograd.

    The plain loss finds its argmins through the |x|^2 + |y|^2 - 2x.y
    expansion, whose rounding (~1e-7 here) can pick the other of two keys
    at nearly the same distance; that moves the gradient of the points
    involved by up to twice the distance between the two keys. Such a
    flip must be a near tie (the two candidates' exact distances within
    NEAR_TIE); every point no flip touches is held to 5e-3.
    """
    from hyperpocket_tpu_torch.ops.chamfer import batch_pairwise_sqdist, chamfer_loss
    from hyperpocket_tpu_torch.ops.nn import chamfer_loss_streaming, nn_one_direction

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    gts = torch.randn((TRAIN_BATCH, N_OUT, 3), generator=gen, device=device) * 0.3
    preds = (torch.randn((TRAIN_BATCH, N_OUT, 3), generator=gen, device=device) * 0.3)
    preds.requires_grad_()

    def value_and_grad(loss_fn):
        loss = loss_fn(gts, preds)
        return loss, torch.autograd.grad(loss, preds)[0]

    got, g_got = value_and_grad(chamfer_loss_streaming)
    want, g_want = value_and_grad(chamfer_loss)
    rel = abs(got.item() - want.item()) / abs(want.item())

    with torch.no_grad():
        p = batch_pairwise_sqdist(gts, preds)
        plain_i1, plain_i2 = p.argmin(dim=2), p.argmin(dim=1)
        del p
        d1, i1 = nn_one_direction(gts, preds)
        d2, i2 = nn_one_direction(preds.detach(), gts)
        i1, i2 = i1.long(), i2.long()

        def exact(a, b, idx):  # the kernels' arithmetic to the keys at idx
            diff = torch.gather(b, 1, idx[..., None].expand(-1, -1, 3)) - a
            sq = diff * diff
            return (sq[..., 0] + sq[..., 1]) + sq[..., 2]

        flips1, flips2 = i1 != plain_i1, i2 != plain_i2
        gaps = torch.cat([(exact(gts, preds, plain_i1) - d1)[flips1],
                          (exact(preds, gts, plain_i2) - d2)[flips2]])
        touched = flips2.clone()  # a pred's own NN flipped, or a gt's NN moved to or from it
        rows = torch.arange(TRAIN_BATCH, device=device)[:, None].expand_as(i1)
        touched[rows[flips1], i1[flips1]] = True
        touched[rows[flips1], plain_i1[flips1]] = True
        err = (g_got - g_want).abs().amax(dim=2)
        grad_err = err[~touched].max().item()
        grad_err_all = err.max().item()
        grad_rel_l2 = ((g_got - g_want).norm() / g_want.norm()).item()
    n_flips = int(flips1.sum() + flips2.sum())
    max_gap = gaps.max().item() if n_flips else 0.0
    print(f"chamfer B=64: value {got.item()!r} vs plain {want.item()!r} (relative {rel!r}); "
          f"{n_flips} argmin flips of {flips1.numel() + flips2.numel()} points, largest exact "
          f"distance gap {max_gap!r}; grad max_abs_err {grad_err!r} on the "
          f"{int((~touched).sum())} points no flip touches, {grad_err_all!r} over all, "
          f"relative L2 {grad_rel_l2!r}")
    check(bool(torch.isfinite(g_got).all()), "non-finite Chamfer gradient")
    check(rel <= CHAMFER_RTOL, f"Chamfer value relative error {rel} > {CHAMFER_RTOL}")
    check(max_gap <= NEAR_TIE, f"an argmin flip is not a near tie: gap {max_gap} > {NEAR_TIE}")
    check(n_flips <= 1e-3 * (flips1.numel() + flips2.numel()), f"{n_flips} argmin flips")
    check(grad_err <= CHAMFER_GRAD_ATOL, f"Chamfer gradient error {grad_err} > {CHAMFER_GRAD_ATOL}")
    times = {
        "chamfer_value_and_grad_ms_b64": cuda_ms(lambda: value_and_grad(chamfer_loss_streaming)),
        "plain_ms": cuda_ms(lambda: value_and_grad(chamfer_loss), iters=3),
    }
    print(f"chamfer value_and_grad timing: {json.dumps(times)}")
    return {"rel": rel, "grad_err": grad_err, "grad_err_all": grad_err_all,
            "grad_rel_l2": grad_rel_l2, "argmin_flips": n_flips, "max_tie_gap": max_gap, **times}


def train_batch(model, batch: int, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    return {
        "existing": torch.randn((batch, N_EXISTING, 3), generator=gen, device=device) * 0.3,
        "missing": torch.randn((batch, N_EXISTING, 3), generator=gen, device=device) * 0.3,
        "gt": torch.randn((batch, N_OUT, 3), generator=gen, device=device) * 0.3,
        "vae_eps": torch.randn((batch, model.get_noise_size()), generator=gen, device=device),
    }


def first_step_grads(model, params, batch, balls, loss_fn) -> torch.Tensor:
    """All trainable gradients of one step's loss, flattened, on injected noise."""
    from hyperpocket_tpu_torch.train.losses import kld_loss

    model.zero_grad(set_to_none=True)
    rec, mu, sigma = model.apply(batch["existing"], batch["missing"], None, 1.0,
                                 num_output_points=N_OUT, training=True,
                                 vae_eps=batch["vae_eps"], ball_points=balls)
    loss = loss_fn(batch["gt"], rec) + kld_loss(mu, sigma, rec.shape[0])
    loss.backward()
    grads = torch.cat([p.grad.flatten() for p in params if p.grad is not None])
    model.zero_grad(set_to_none=True)
    return grads


def drive_training(config: dict, model32, device) -> dict:
    """The training slice: train steps and val steps in fp32 and bf16, with launch counts."""
    from hyperpocket_tpu_torch.ops.chamfer import chamfer_loss
    from hyperpocket_tpu_torch.ops.nn import nn_min_fused, nn_one_direction
    from hyperpocket_tpu_torch.ops.sampling import generate_target_network_input_batch
    from hyperpocket_tpu_torch.ops.trunk_pool import trunk_pooled
    from hyperpocket_tpu_torch.train import optim, trainer
    from hyperpocket_tpu_torch.train.losses import reconstruction_loss

    tr = config["training"]
    trainer.set_matmul_precision(tr.get("matmul_precision", "highest"))
    loss_coef = float(tr["loss_coef"])
    out = {}
    kernels = (nn_one_direction, nn_min_fused, trunk_pooled)

    def reset():
        for k in kernels:
            k.launches = 0

    def counts():
        return {"nn_one_direction": nn_one_direction.launches,
                "nn_min_fused": nn_min_fused.launches, "trunk_pool": trunk_pooled.launches}

    for dtype, steps in (("float32", 5), ("bfloat16", 3)):
        model = copy.deepcopy(model32)
        model.compute_dtype = dtype
        model = model.to(device)
        params = optim.trainable_parameters(model)
        opt = optim.make_optimizer(tr["optimizer"], params)
        train_step = trainer.make_train_step(model, opt, loss_coef)
        val_step = trainer.make_val_step(model, loss_coef)
        batch = train_batch(model, TRAIN_BATCH, SEED + 3, device)
        gen = torch.Generator(device=device).manual_seed(SEED + 4)
        res = {}
        if dtype == "float32":
            balls = generate_target_network_input_batch(
                model.target_network_input, gen, 1.0, TRAIN_BATCH, N_OUT)
            reset()
            g_kernel = first_step_grads(model, params, batch, balls,
                                        lambda gt, rec: reconstruction_loss(gt, rec, loss_coef))
            k1_grad = nn_one_direction.launches
            g_plain = first_step_grads(model, params, batch, balls,
                                       lambda gt, rec: loss_coef * chamfer_loss(gt, rec))
            check(k1_grad == 2 and nn_one_direction.launches == 2,
                  f"the gradient check launched K1 {k1_grad} / {nn_one_direction.launches} times")
            rel = ((g_kernel - g_plain).norm() / g_plain.norm()).item()
            print(f"training fp32: first-step gradients, kernels vs plain Chamfer, "
                  f"relative L2 {rel!r} (limit {STEP_GRAD_REL_L2})")
            check(rel <= STEP_GRAD_REL_L2, f"first-step gradient relative L2 {rel}")
            res["first_step_grad_rel_l2"] = rel

        before = [p.detach().clone() for p in params]
        losses = []
        reset()  # the main path: train steps, then the val step
        for i in range(steps):
            loss, loss_r, loss_k, rec = train_step(batch["existing"], batch["missing"],
                                                   batch["gt"], gen, 1.0, N_OUT)
            losses.append([loss.item(), loss_r.item(), loss_k.item()])
        torch.cuda.synchronize()
        train_counts = counts()
        val = train_batch(model, VAL_BATCH, SEED + 5, device)
        reset()
        val_loss, val_rec = val_step(val["existing"], val["missing"], val["gt"], gen, 1.0, N_OUT)
        torch.cuda.synchronize()
        val_counts = counts()
        print(f"training {dtype}: losses per step (all, rec, kld) {losses}, "
              f"val loss {val_loss.item()!r}; launches in {steps} train steps {train_counts}, "
              f"in the val step {val_counts}")
        check(all(np.isfinite(v) for row in losses for v in row), f"{dtype}: non-finite loss")
        check(bool(torch.isfinite(val_loss)) and val_rec.shape == (VAL_BATCH, N_OUT, 3)
              and bool(torch.isfinite(val_rec).all()), f"{dtype}: bad val step output")
        check(rec.shape == (TRAIN_BATCH, N_OUT, 3) and rec.dtype == torch.float32,
              f"{dtype}: reconstruction {tuple(rec.shape)} {rec.dtype}")
        check(all(not torch.equal(p, b) for p, b in zip(params, before) if p.grad is not None),
              f"{dtype}: a parameter with a gradient did not change")
        check(train_counts == {"nn_one_direction": 2 * steps, "nn_min_fused": 0, "trunk_pool": 0},
              f"{dtype}: {steps} train steps launched {train_counts}")
        want_val = {"nn_one_direction": 0, "nn_min_fused": 1,
                    "trunk_pool": 2 if dtype == "bfloat16" else 0}
        check(val_counts == want_val, f"{dtype}: the val step launched {val_counts}")

        res.update(losses=losses, val_loss=val_loss.item(), train_launches=train_counts,
                   val_launches=val_counts)
        res["train_step"] = step_ms(lambda i: train_step(batch["existing"], batch["missing"],
                                                         batch["gt"], gen, 1.0, N_OUT))
        res["val_step_b64"] = step_ms(lambda i: val_step(batch["existing"], batch["missing"],
                                                         batch["gt"], gen, 1.0, N_OUT))
        print(f"training {dtype} timing B={TRAIN_BATCH}: train step "
              f"{json.dumps(res['train_step'])}, val step {json.dumps(res['val_step_b64'])}")
        out[dtype] = res
        del model, opt, train_step, val_step
        torch.cuda.empty_cache()
    return out


def _device_ms_by_kernel(fn, calls: int) -> dict:
    """Device time per call by kernel name over ``calls`` calls (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for s in range(calls):
            fn(s)
        torch.cuda.synchronize()
    kernels = collections.Counter()
    for evt in prof.events():
        # a user annotation (the optimizer's step range) spans kernels counted on their own
        if evt.device_type == DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            kernels[evt.name[:100]] += evt.time_range.elapsed_us() / 1e3 / calls
    return kernels


def profile(config: dict, model, model32, device, path: Path, calls: int = 5) -> dict:
    """Wall time per serving call and train step, and device time per call by kernel."""
    from hyperpocket_tpu_torch import serving
    from hyperpocket_tpu_torch.train import optim, trainer

    gen = torch.Generator(device=device).manual_seed(4)
    report = {}

    def record(name, fn, wall_ms, calls):
        kernels = _device_ms_by_kernel(fn, calls)
        check(bool(kernels), f"{name}: torch.profiler saw no device time")
        device_ms = sum(kernels.values())
        report[name] = {"wall_ms": wall_ms, "device_ms": device_ms, "busy": device_ms / wall_ms,
                        "kernels_ms": dict(kernels.most_common())}
        print(f"profile {name}: wall {wall_ms!r} ms, device {device_ms!r} ms, "
              f"busy {device_ms / wall_ms!r}")

    for batch in (BENCH_BATCH, SERVE_BATCH):
        existing = torch.randn((batch, N_EXISTING, 3), generator=gen, device=device) * 0.3
        noise = torch.randn((batch, model.get_noise_size()), generator=gen, device=device) * 0.1
        for name, m in (("bf16", model), ("fp32", model32)):
            f = serving.make_serving_fn(m, num_output_points=N_OUT, device=device)
            wall_ms = 1e3 * batch / clouds_per_s(lambda s: f(existing, noise, s), batch,
                                                 iters=20, windows=1)["clouds_per_s"]
            record(f"{name}_B{batch}", lambda s: f(existing, noise, s), wall_ms, calls)

    tr = config["training"]
    for name, dtype in (("fp32", "float32"), ("bf16", "bfloat16")):
        m = copy.deepcopy(model32)
        m.compute_dtype = dtype
        m = m.to(device)
        opt = optim.make_optimizer(tr["optimizer"], optim.trainable_parameters(m))
        step = trainer.make_train_step(m, opt, float(tr["loss_coef"]))
        batch = train_batch(m, TRAIN_BATCH, SEED + 6, device)

        def run(s):
            return step(batch["existing"], batch["missing"], batch["gt"], gen, 1.0, N_OUT)

        wall_ms = step_ms(run, iters=10, windows=1)["ms"]
        record(f"train_step_{name}_B{TRAIN_BATCH}", run, wall_ms, 3)
        del m, opt, step
        torch.cuda.empty_cache()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=1))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=Path, default=None, metavar="PATH",
                    help="also write the per-kernel device time of serving calls and "
                         "train steps to PATH")
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
    nn_kern = nn_kernels_vs_plain(device)
    cham = chamfer_vs_plain(device)
    print(f"chamfer: {json.dumps(cham)}")
    training = drive_training(config, model32, device)
    print(f"training: {json.dumps(training)} on {card}")
    if args.profile is not None:
        profile(config, model, model32, device, args.profile)
        print(f"profile: written to {args.profile}")

    t256 = kern["times"]["B256_N1024"]
    fp32 = training["float32"]
    kernels = [{
        "name": "trunk_pool",
        "route": "cuda",
        "source": "hyperpocket_tpu_torch/csrc/trunk_pool.cu",
        "replaces": "hyperpocket_tpu/ops/pallas_encoder.py:198",
        "launches": sl["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": t256["kernel_ms"],
        "plain_ms": t256["plain_ms"],
    }]
    for name, line, launches in (
            ("nn_one_direction", 125, fp32["train_launches"]["nn_one_direction"]),
            ("nn_min_fused", 223, fp32["val_launches"]["nn_min_fused"])):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"hyperpocket_tpu_torch/csrc/{name}.cu",
            "replaces": f"hyperpocket_tpu/ops/pallas_nn.py:{line}",
            "launches": launches,
            "max_abs_err": nn_kern["errs"][name],
            "ms": nn_kern["times"][name]["ms"],
            "plain_ms": nn_kern["times"][name]["plain_ms"],
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
