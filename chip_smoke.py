#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, artifact, training, experiments, CLI and parallel paths on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card::

    python3 chip_smoke.py

Phases, each fatal on any error:

1. device: CUDA must be present; prints the card's name and power limit
   (``nvidia-smi``), with its SM clock, power draw and temperature at the
   start and at the end of the run, and turns TF32 off for fp32 matmuls and
   cuDNN.
2. build: compiles ``hyperpocket_tpu_torch/csrc/*.cu`` with nvcc (sm_90a),
   one nvcc per source, all started together, and prints ptxas' registers,
   shared memory and spills of the trunk kernels' two instantiations (K4,
   K8), of the fused NN sweep's two copies (K5, K9), of the bf16 decode
   kernel's two instantiations (K10: up to 128 and up to 256 channels), of
   the CUDA-core decode kernel's two (K10: fp32 and bf16 values) and of the
   decode's backward and its chunk sum (``decode_batch_grad.cu``); a
   spill fails the run.
3. trunk kernel vs plain: the trunk kernel (``ops/trunk_pool.py``) against its
   plain PyTorch version on the card, at the serving shapes and at ragged,
   single-cloud, odd-tile-count (1, 2, 5 tiles) and tied inputs and with
   layer-5 biases shifted to negative maxima, on the served model's weights;
   max |kernel - plain| <= 2e-2, the JAX package's bound for this kernel;
   timed with CUDA events beside the plain version and the cuBLAS bf16 chain
   (+ ``amax``), with the ratio to the chain and the share of the bound.
4. serving slice: the chair config at full width in bf16, weights from seed 1856
   (every bias drawn anew, distinct per channel, as trained weights have
   them; initialisation zeroes most of them), written as a JAX-layout checkpoint and served through
   ``serving.main(["infer", ...])`` (PLY in, PLY out), then three B=64
   requests through ``make_serving_fn``. Both serve through CUDA graphs
   (below): the trunk kernel and the decode kernel K10 launch 2 times in
   infer's one request and 4 in the three requests, 6 in all; one capture
   and three replays; the replays bit-equal to the eager ``FullModel.apply``
   with the same seeds; equal seeds give equal outputs, another seed
   another output; the bf16 output is held to the fp32 path (K10's fp32
   kernel, no K4) on the same weights and ball points (relative L2 <= 0.1).
5. serving throughput: bf16 and fp32 ``make_serving_fn`` at B=256 and B=64,
   through its graphs and eagerly (``FullModel.apply``) in one process:
   the first call's ms (warm-up, capture, replay), clouds/s in turns
   (graph, eager, eager, graph; all clouds over all the synchronised time
   of 5 windows of 10 calls, each window's rate beside it), device ms a
   call (``torch.profiler``) and the busy share (device over wall), and
   each graph's pool bytes and capture ms.
6. NN kernels vs plain: K1 (``nn_one_direction``) and K3 (``nn_min_fused``,
   ``ops/nn.py``) against their plain versions at B=64 and B=60 with
   N=M=2048, ragged clouds (B=3, N=200, M=136), more keys than one staged
   chunk (M=4500), duplicated keys (ties) and clouds whose points are all
   equal, in both directions: K1's indices equal, distances within
   1e-6; each kernel and plain version timed with CUDA events at B=64.
7. Chamfer value and gradient at B=64, N=M=2048: the streaming loss (K1
   twice, the gather/scatter backward) against the plain
   ``ops/chamfer.py::chamfer_loss`` under autograd: value within 1e-5
   relative; where the two pick different argmins (or the plain one splits
   a tie of its rounded distances), the keys must be a near tie (exact
   distances within 1e-6), and every point no such flip touches has its
   gradient within 5e-3; both timed.
8. training slice: the chair config at full width, the same weights, Adam
   and ``loss_coef`` from the config, B=64 (existing and missing 1024 points,
   gt 2048). fp32: the first step's gradients through the kernels against
   the plain Chamfer's on the same injected noise and ball points (relative
   L2 <= 1e-3), then 5 train steps (K9 once per step, K1 never: the card's
   Chamfer route, ``ops/nn.py::chamfer_grad_route``) and a val step at
   B=60 (K3 once, K10 once); bf16: 3 train steps (K9 once each, K10 and
   its backward once each: ``decode_grad_route``) and a val step (K4
   twice, K3 once, K10 once); fp32 train steps launch no K10. Losses
   finite, parameters changed; train and val step times at B=64.

9. EMD kernels vs plain: K6 (``match_cost_fwd_kernel``) and K7
   (``match_cost_bwd_kernel``, ``ops/emd.py``) against their plain versions
   at the eval dispatch (B=512, N=M=1024), B=64 with N=M=2048, unequal
   counts (2048x1024, 1024x2048, 300x128), ragged (200x136), B=1 and
   coincident clouds (x == y): costs within rtol 1e-4; gradients within
   relative L2 1e-4 and every entry within 1e-2 of the tensor's largest
   (the share of entries beyond 1e-4 of it and the worst entry's elementwise
   ratio are printed); both kernels deterministic; each kernel and plain
   version timed with CUDA events at the first two shapes.
10. EMD descent: the JAX package's descent check (B=16, N=M=128, ten steps of
   gradient descent on the match cost) through ``match_cost`` on the card
   (K6 and K7) and through the plain forward and backward called directly:
   loss trajectories within rtol 2e-3, the loss falls, K6 and K7 launch 10
   times each.
11. experiments slice: the chair weights above in fp32, written as a
   JAX-layout checkpoint for each of ``settings/config_missing_shapenet.json``
   (``evaluate_generativity``) and ``settings/config_3depn_chair.json``
   (``fixed`` + ``compute_mmd_tmd_uhd``), each run through
   ``hyperpocket_tpu_torch.cli.main`` on a corpus of 16 objects of one
   category that the smoke writes itself; only ``mode``, ``dataset.path``,
   ``dataset.classes`` and ``results_root`` are overridden. Metrics must be
   finite; K6 and K3 must launch once per 512-pair dispatch, and
   ``compute_mmd_tmd_uhd`` must launch K3 as its calls require; K10 launches
   once per inference forward of the model (at least once each). The wall
   time of each experiment and of its parts is printed.

12. trunk-argmax kernel K8 vs plain (``ops/trunk_pool.py::trunk_pooled_argmax``)
   on the served model's encoder at B=64 and B=256 (N=1024), ragged clouds,
   1, 2 and 5 tiles, and duplicated points (in one tile, across tiles, in
   the two CTAs of a cluster and across clusters): pooled values equal to
   K4's bits and to the maxima of the kernel's own per-point values (K4 on
   single points), indices the first point reaching them; against the plain
   version pooled within 2e-2, the plain value at K8's point within 2e-2 of
   the plain maximum, indices equal where that maximum leads its channel by
   more than 4e-2, duplicates resolved to the first copy, two launches equal;
   K8 timed beside K4, the plain version and cuBLAS bf16 + ``torch.max``,
   with the ratio to the latter.
13. head-Adam kernel K11 vs plain (``ops/head_adam.py``) at the head's shape
   (19011 x 2048, B=64), bf16 inputs and moments, count 5: p within 2 lr
   everywhere and within two fp32 steps plus 1e-5 lr on all but 1e-4 of the
   entries, m and v within one bf16 step; deterministic; timed beside the
   plain ``torch.mm`` + elementwise Adam.
14. training through the CLI: a 3D-EPN train corpus of 32 chairs x 4 halves
   (128 items) the smoke writes, then ``cli.main`` in training mode (or, where
   matplotlib is missing, ``Trainer.run(plot_samples=False)``) for
   ``config_3depn_chair.json`` (fp32) and ``config_3depn_chair_fast.json``
   (bf16, bf16 Adam moments, ``compute_dtype_switch`` at epoch 1, K8 with
   no variable set), 2 epochs each, then a relaunch with max_epoch
   3 that must resume at epoch 3; files written, epoch times and ms per step,
   launches (K9 once a train step, K3 once a val batch, K8 twice a bf16 train
   step, K4 twice a bf16 val batch, K10 once per inference forward, and in
   the fast config adam_lowp once a step for each tensor with a gradient).
15. fused train step: 3 steps of ``make_fused_train_step`` (K11 once a step)
   against ``make_train_step`` at full width, B=64, bf16, from the same
   weights and draws: step-0 losses within 1e-6, all within 1e-2.
16. K5 (``nn_fused_planes``) and the partial-to-completion NN path: the
   chair served in fp32 completes B=64 halves of 1024 points into 2048, then
   ``ops.nn_distance_pallas(existing, completion)`` (K5, backward K2) and
   ``ops.chamfer_loss_auto`` under grad (K9): each launches once and K1
   never, both gradients that of ``nn_backward`` on K5's indices. K5
   against its plain version and against K1 run once each way at B=64 with
   1024x2048, 2048x1024 and 2048x2048, ragged clouds, more keys than one
   staged chunk, duplicated points on both sides, duplicated keys half the
   cloud apart (in different key splits) and clouds of one repeated point:
   distances bit-equal, indices equal; the M=4500 case again with the keys
   in one and in two splits, so that a block sweeps several chunks through
   its double buffer. Timed at 1024x2048, 2048x1024 and 2048² beside K1
   twice (``ratio_to_k1_twice``), K3, the plain version and cdist +
   min/argmin both ways, with the share of the bound reached.
17. K9 (``chamfer_loss_grad``) through ``chamfer_loss_fused`` at B=64,
   2048x2048 and 2048x1024: one launch per value and gradient; value and
   per-sample losses within 1e-5 relative of K3's; both fields within 1e-5
   of their largest entry against ``nn_backward`` on K5's indices; the
   gradient of 3 loss 3x the gradient; against the plain autograd by phase
   7's near-tie rules. Timed beside phase 7's route, K3 (``ratio_to_k3``)
   and the plain version, with the share of the bound reached.
18. K10 (``decode_batch``; bf16 on the tensor cores, ``decode_batch_tc.cu``,
   fp32 and wider bf16 layers on the CUDA cores, ``decode_batch.cu``) on the
   served model's own flat weights (the hypernetwork's output for B=256 and
   B=64 requests, bf16 and fp32) and ball points, N=2048, through
   ``ops.decode_batch`` in the model's (chain) rounding (one launch each)
   and in the TPU kernel's: within 2e-5 (fp32) or 0.05 (bf16) of the
   output's largest entry of the plain version of the same rounding and of
   the model's ``bmm`` chain, with the bf16 steps to the plain version
   printed, and in bf16 equal to its own rounding's plain version more
   often than to the other's; rows that start off the 16-byte grid in both
   dtypes; the JAX tests' 8 channel/bias cases at B=3, N=64 and the wide
   widths (272,), (256, 256), (512, 1024, 512), (4096,), (32, 4096, 32) at
   B=2, N=300, both dtypes and both roundings, fp32 elementwise within 2e-5
   and bf16 within one bf16 step or 2e-2 of the largest entry (the wide
   bf16 ones launch the CUDA-core kernel's bf16 instantiation); a bf16 chair
   model with a 272-channel target layer served once through
   ``FullModel.apply`` (one launch of that instantiation, within the bf16
   gate of the plain decode). At B=64 and B=256 in both dtypes, and for
   the bf16 CUDA-core instantiation at 272 channels, B=64: the kernel's
   device time (launches queued behind a sleep, so no host gap counts) and
   its time per call in the chain rounding and in the TPU kernel's, the
   ``bmm`` chain's and the plain version's, with the share of the bound
   reached and the ratio to the chain.

19. export: the served chair model exported on the card
   (``serving.export_completion``) in bf16 and fp32 at B=64 and B=256,
   written to a file and loaded back (``load_completion``): at B=64 the
   artifact's completion within 2e-2 (bf16, K4's bound) or 1e-5 (fp32) of
   the output's scale of ``make_serving_fn``'s for the same seed and noise,
   equal seeds equal, another seed another; the bf16 graph holds the op
   ``hyperpocket.trunk_pooled`` (fp32 does not) and both hold
   ``hyperpocket.decode_batch``; the export launches no K4 and no K10, each
   bf16 artifact call one K4, each artifact call one K10 (replays of the
   captured program), the replays bit-equal to the loaded module called
   directly. At B=64 and B=256 the artifact graphed and its module called
   directly timed as in phase 5, beside ``make_serving_fn``'s clouds/s
   (nothing is claimed for them).
20. serving CLI: on the bf16 chair checkpoint and phase 14's 3D-EPN corpus,
   ``serving.main`` runs ``export`` (sidecar keys), ``infer --artifact``
   (6 PLYs of 2048 finite points, K4 and K10 twice: one request, warm-up and
   replay), ``fit-prior`` (a finite prior of the noise size) and ``infer
   --latent-prior`` (6 PLYs, K4 and K10 twice); a prior
   of another dim is refused before any completion.
21. HyperRec: ``settings/config_completion.json``'s model at full width,
   fp32 with TF32 off, B=66 partial and gt clouds of 2048 points: the first
   step's gradients through the kernels against the plain Chamfer's
   (relative L2 <= 1e-3, K9 once), then 3 train steps (K9 once a step, no
   K1, K3, K4 or K10) and a val step at B=10 (K3 once, K10 once), ms per step. Where ``h5py``
   is installed, a synthetic Completion3D ``.list``/``.h5`` tree is read
   through ``get_datasets``; where it is not, one line says so.
   Phases 19-21 print their wall time.

22-25. the parallel layer (``parallel/``), each over a one-rank NCCL group
   on a file store in the phase's temp dir (NCCL takes one rank per card:
   larger worlds are proven on the CPU, over gloo). 22: a ``Trainer`` with
   ``use_mesh=True`` and the one-process Trainer on the full-width chair
   config in fp32, one epoch of 3 steps at B=64 on a 192-item 3D-EPN corpus
   the smoke writes and its val epoch each, with deterministic algorithms
   (K2's ``index_add_`` sums by CUDA atomics otherwise; under them the loss
   takes the streaming Chamfer, K9's gradients being atomic sums too):
   losses, parameters and val loss bit-equal; K1 twice a step, K3 and K10
   once a val batch;
   both step times, with the default algorithms.
   23: ``chamfer_loss_point_sharded`` at B=64, 2048x2048 (K1 twice) and
   1024x2048 (K5 once) against the plain ``chamfer_loss`` by phase 7's
   gates, timed beside ``chamfer_loss_streaming`` and the plain loss. 24:
   ``pairwise_emd_cd_multi(mesh=)`` on one 512-pair dispatch (N=M=1024):
   every pair equal to the unsharded call's, K6 and K3 once. 25:
   ``make_serving_fn(mesh=)`` and a ``data_parallel=1`` artifact in bf16 at
   B=256, each a graph that holds the all-gather, bit-equal to
   ``make_serving_fn`` and to the plain artifact (K4 and K10 4 times in
   their two first requests), in clouds/s beside them. Phases 22-25 print
   their wall time.

26. scanned epochs (``training.epoch_mode: "scan"``, ``train/epoch_scan.py``):
   ``Trainer`` in "scan" and in "step" mode on the full-width chair config
   at B=64 on a 130-chair x 4-half 3D-EPN corpus the smoke writes (8
   uniform train steps and a ragged one of 8 an epoch, ``drop_last``
   false; val at B=60, 8 uniform batches and one of 40), in fp32, bf16 and
   the fast config (both bf16 cases train through K8, the card's route; the
   fast config's dtype switch at epoch 1, so epoch 2 recaptures in fp32),
   2 epochs and their val epochs
   each, with deterministic algorithms (the streaming Chamfer, K1 twice a
   step): loss rows, val losses and parameters bit-equal to the step
   loop's; 2 scanned epochs and 2 scanned val categories, 16 + 16 replays,
   and launches equal to the step loop's plus one rehearsal step a compute
   dtype (the fast config's adam_lowp once a tensor a step). Then, with the
   default algorithms, on an epoch's uniform prefix already on the card (no
   loader), train and val: ms per step both ways in turns (step, scan,
   scan, step, step, scan), the capture's ms and each way's busy share over
   one epoch (``torch.profiler``; the scan's over its replays, and with its
   capture).

27. the training path's Chamfer route and the bf16-moment Adam: the
   adam_lowp kernel (``ops/adam_lowp.py``) against its plain version on
   the chair model's 44 trainable tensors, three steps bit for bit
   (parameters and both moments) for each pair of parameter dtype (fp32,
   bf16, fp16) and moment dtype (bf16, fp16, fp32), Adam and AdamW with
   decay, and the fast config's Adam with bf16 and fp16 moments eagerly and
   replayed in a captured step; timed a step beside the plain loop and
   torch's fused Adam (fp32 moments). K9's value and gradient captured in a
   CUDA graph and replayed on new clouds within 1e-5 of the eager call.
   Then the previous path ("parent": the streaming Chamfer and the plain
   Adam loop) against this one ("change": K9 and adam_lowp) in turns (A B
   B A, twice): the loss's value and gradient at B=64, 2048x2048 and
   2048x1024; train steps at B=64 in the step loop for the chair config in
   fp32 and bf16, the fast config (bf16, bf16 moments, K8) and HyperRec at
   B=66; scanned epochs (phase 26's Trainer) for the three chair cases;
   on the fast config's scanned epoch, K8 against the cuBLAS trunk in
   turns, each way's busy share, adam_lowp's device ms a step and a
   replay's launches. Phase 27 prints its wall time.

28. the device slicer (``data/slicer.py::slice_point_cloud_device``, plain
   torch, no kernel of its own): 64 chair clouds of 2048 points (the
   ellipsoid surfaces the smoke's corpora hold) cut to 1024 + 1024 with
   150,000 plane draws a cloud injected from a numpy seed, bit-equal to
   the same call on the CPU, each output a partition of its cloud; then
   from a card generator: clouds/s at B=64 and at B=1 beside the host
   ``slice_point_cloud`` on the first 8 clouds, draws tested and blocks a
   cloud, and the host syncs of a B=64 call (``torch.cuda``'s sync debug
   mode: one a block). Phase 28 prints its wall time.

29. the bf16 training decode (``ops/decoder.py::decode_batch_train``: K10's
   forward, then ``decode_batch_grad``, ``csrc/decode_batch_grad.cu``) at
   B=64, N=2048 on the served model's own flat weights and ball points: the
   route "k10"; the flat gradient against its plain version and the
   chain's autograd (relative L2 <= 1e-2), two runs bit-equal, the training
   decode's value and gradient against the chain's; small, ragged, no-bias
   and wide widths (hidden layers of 120 and 128 channels) against
   the plain version; then the forward and backward both ways in turns (A
   B B A, twice, device ms), the forward's and the backward's ms alone and
   the least time of the work. Phase 29 prints its wall time.

Serving through CUDA graphs (phases 4, 5, 19, 20, 25 and the profile):
every serving callable captures its forward once for each input signature
and replays it (``utils/cuda_graph.py::GraphCache``). A signature's first
call runs the forward once eagerly to warm up, captures it (the launches
the capture records are taken back) and replays it, so each wrapper counts
2 launches for that call and 1 for every later call: the launches the card
ran.

``--profile PATH`` adds a phase that writes, for bf16 and fp32 serving at
B=256 and B=64 (and the bf16 artifact of phase 19 at both), one fp32 and
one bf16 train step at B=64 (the bf16 one also with K8 and with K11's
fused head step) and one 512-pair CD + EMD dispatch of
``evaluate_generativity`` at N=M=1024, the wall time per call and the
device time per call by kernel (``torch.profiler``) to PATH as JSON.

The line before the last is a JSON object with, for each kernel, its
launches on its path, its error against its plain version, its time, the
plain version's, the least time the card could take (``bound_ms``, from the
published peaks and this run's shapes) and one PyTorch call's time where one
computes the same function; the last line is ``{"ok": true, "device":
{...}}``. Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import io
import json
import math
import os
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
COMPLETION_CONFIG = ROOT / "settings" / "config_completion.json"
SEED = 1856
KERNEL_ATOL = 2e-2  # tests/test_pallas_encoder.py: bf16 per-layer rounding
REL_L2_TOL = 0.1
ARTIFACT_FP32_TOL = 1e-5  # artifact vs make_serving_fn, of the output's scale
NN_ATOL = 1e-6  # K1/K3 vs plain: the same arithmetic, the same bits
CHAMFER_RTOL = 1e-5  # the fp32 parity budget
CHAMFER_GRAD_ATOL = 5e-3  # tests/test_pallas_nn.py: argmin near-ties
NEAR_TIE = 1e-6  # the plain loss's expansion rounds distances by ~1e-7 here
STEP_GRAD_REL_L2 = 1e-3
EMD_RTOL = 1e-4  # tests/test_pallas_emd.py: the cost
# the gradients: relative L2 within 1e-4 (the JAX package's rtol, over each
# tensor) and every entry within 1e-2 of the tensor's largest entry. Two fp32
# evaluations of the 9 rounds part at a few entries: the kernel and its plain
# version by up to 4.0e-3 of that scale on these and the card tests' inputs,
# and each lies up to 9.2e-3 from an fp64 evaluation; kernels with a broken
# round or a dropped query read 0.26 or more (PERF.md)
EMD_GRAD_REL_L2, EMD_GRAD_MAX, EMD_GRAD_ATOL = 1e-4, 1e-2, 1e-6
DESCENT_RTOL = 2e-3  # tests/test_pallas_emd.py::test_emd_descent_parity_pallas_vs_xla
# K11 vs plain: p within 2 lr everywhere (a near-zero dw may flip the update's
# sign) and within two fp32 steps of p plus 1e-5 lr on all but 1e-4 of the
# entries; m and v within one bf16 step plus 1e-6 of the tensor's largest
# entry (tests/test_torch_cuda.py)
HEAD_SHARE = 1e-4
HEAD_N, HEAD_K = 19011, 2048
FUSED_STEP_RTOL = 1e-2  # bf16 compute: autograd rounds dW to bf16, K11 keeps it fp32
TRAIN_MODELS, TRAIN_SAMPLES = 32, 4  # 128 train items: 2 steps of B=64 an epoch
DP_TRAIN_STEPS = 3  # phase 22's epoch: 48 chairs x 4 halves at B=64
SCAN_MODELS = 130  # phase 26: 520 items, 8 steps of B=64 and one of 8 an epoch
# phase 28: an accepted plane is about 1 in 4,000-10,000 on these clouds, so
# a cloud's 150,000 draws run out with a chance below 1e-6
SLICE_CLOUDS, SLICE_DRAWS, SLICE_HOST_CLOUDS = 64, 150_000, 8
# the H100 SXM's published peaks: HBM bytes/s, dense
# bf16 tensor-core FLOP/s, fp32 FLOP/s outside the tensor cores and the fp32
# issue rate (instructions/s, half the FMA-counted FLOP/s)
HBM_BYTES_S, BF16_FLOPS, FP32_FLOPS = 3.35e12, 989e12, 67e12
FP32_LANE_RATE = FP32_FLOPS / 2
EVAL_CONFIGS = ("config_missing_shapenet.json", "config_3depn_chair.json")
EVAL_CATEGORY = "03001627"  # chair: the one category each eval corpus holds
EVAL_OBJECTS = 16
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


def clock_line() -> str:
    """The card's SM clock, power draw and temperature now (``nvidia-smi``)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                          "--format=csv,noheader"],
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


def bound(bytes_moved: float, op_seconds: float) -> dict:
    """The least time for the work: the larger of bytes over the HBM rate and
    the operations' time at their peak rates (``op_seconds``)."""
    byte_s = bytes_moved / HBM_BYTES_S
    return {"bound_ms": 1e3 * max(byte_s, op_seconds),
            "bound_by": "bytes" if byte_s >= op_seconds else "operations"}


def pair_bound(q: torch.Tensor, k: torch.Tensor, out_bytes: int, per_pair: int) -> dict:
    """An NN sweep: ``per_pair`` issued instructions a (query, key) pair; the
    clouds read once and ``out_bytes`` written once."""
    pairs = q.shape[0] * q.shape[1] * k.shape[1]
    return bound(4 * (q.numel() + k.numel()) + out_bytes, per_pair * pairs / FP32_LANE_RATE)


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    """One bf16 step at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def trunk_bound(batch: int, n: int, out_bytes: int) -> dict:
    """K4/K8: layers 2-5 on the bf16 tensor cores, layer 1 (K=3) in fp32;
    x read once, the 0.87 MB of layers once, the outputs written once."""
    from hyperpocket_tpu_torch.ops.trunk_pool import WIDTHS

    macs = [WIDTHS[i] * WIDTHS[i + 1] for i in range(len(WIDTHS) - 1)]
    rows = batch * n
    layer_bytes = 2 * sum(m + WIDTHS[i + 1] for i, m in enumerate(macs))
    return bound(rows * 3 * 2 + layer_bytes + batch * 512 * out_bytes,
                 2 * rows * sum(macs[1:]) / BF16_FLOPS + 2 * rows * macs[0] / FP32_FLOPS)


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


def device_ms(fn, iters: int = 20, windows: int = 5, warmup: int = 3,
              sleep_cycles: int = 20_000_000) -> float:
    """Median over windows of the per-call device time, the calls queued
    behind a sleep kernel (``sleep_cycles``, ~10 ms at 2 GHz by default:
    longer than queueing the calls) so that the host's time per call leaves
    no gap between them (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


@contextlib.contextmanager
def inference_forwards():
    """The compute dtypes of the ``FullModel.apply(training=False)`` calls made
    inside the block: each decodes through K10 once (fp32 and bf16)."""
    from hyperpocket_tpu_torch.models.full_model import FullModel

    inner = FullModel.apply
    calls = []

    def apply(self, *args, training=True, **kwargs):
        if not training:
            calls.append(self.compute_dtype)
        return inner(self, *args, training=training, **kwargs)

    FullModel.apply = apply
    try:
        yield calls
    finally:
        FullModel.apply = inner


def ptxas_check(log: Path, kernel: str, what: str) -> list:
    """ptxas' registers, shared memory and spills of the two entry functions
    whose names hold ``kernel``: K4's and K8's instantiations of
    ``trunk_pool_kernel``, the copies of ``nn_fused_kernel`` in K5's and
    K9's sources, K10's two instantiations of ``decode_batch_tc_kernel`` or
    its two of ``decode_batch_kernel`` (fp32 and bf16 values).
    Spills fail the run."""
    from hyperpocket_tpu_torch.ops import _build

    report = _build.ptxas_report(log.read_text(), kernel)
    for entry in report:
        print(f"ptxas {entry['function']}: {entry.get('registers')} registers, "
              f"{entry.get('static_smem')} bytes static shared memory, "
              f"{entry.get('spill_stores')} bytes spill stores, "
              f"{entry.get('spill_loads')} bytes spill loads")
    check(len(report) == 2, f"ptxas reported {len(report)} {what} kernels, expected 2")
    check(all(e.get("spill_stores") == 0 and e.get("spill_loads") == 0 for e in report),
          f"the {what} kernels spill registers")
    return report


def build_model(compute_dtype: str, config_path: Path = CONFIG, seed: int = SEED):
    """A config's model at full width (the chair's by default); weights and
    biases drawn from ``seed``."""
    from hyperpocket_tpu_torch.models.full_model import FullModel

    config = json.loads(config_path.read_text())
    config["full_model"]["compute_dtype"] = compute_dtype
    gen = torch.Generator().manual_seed(seed)
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
        # 2 and 5 tiles: with B3_N200's 6 and B1_N8's 1, odd counts leave the
        # second CTA of the last cluster without a tile
        "B1_N136": (layers, cloud(1, 136)),
        "B5_N128": (layers, cloud(5, 128)),
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
            # the same five layers as plain bf16 matmuls (cuBLAS) + max
            "bf16_matmul_chain_ms": cuda_ms(lambda: encoder.conv_stack(x).amax(dim=1), iters=10),
            **trunk_bound(x.shape[0], x.shape[1], 2),
        }
        times[name]["ratio_to_chain"] = times[name]["kernel_ms"] / times[name]["bf16_matmul_chain_ms"]
        times[name]["share_of_bound"] = times[name]["bound_ms"] / times[name]["kernel_ms"]
        print(f"trunk timing {name}: {json.dumps(times[name])}")
    return {"max_abs_err": max(errs.values()), "errs": errs, "times": times}


def _per_point_values(layers, x):
    """K4's values at every point of x, (B, N, 512): each point as a cloud of 8
    copies of itself. A row's values do not depend on the other rows of its
    tile, so these are the bits K8 compares inside the whole cloud."""
    from hyperpocket_tpu_torch.ops.trunk_pool import trunk_pooled

    b, n = x.shape[:2]
    return trunk_pooled(layers, x.reshape(b * n, 1, 3).expand(b * n, 8, 3).contiguous()).view(
        b, n, 512)


def trunk_argmax_vs_plain(served, device) -> dict:
    """K8 vs its plain version on ``served``'s bf16 real encoder.

    Exact checks against the kernel's own per-point values (K4 on single
    points): K8's pooled values are their maxima (and K4's pooled output),
    its indices the first point reaching them. Against the plain version
    (another summation order): pooled within KERNEL_ATOL, the plain value at
    K8's point within KERNEL_ATOL of the plain maximum, indices equal where
    the plain maximum leads its channel by more than 2 KERNEL_ATOL.
    """
    from hyperpocket_tpu_torch.ops.trunk_pool import (
        _stack_reference,
        trunk_pooled,
        trunk_pooled_argmax,
        trunk_pooled_argmax_reference,
    )

    bf16 = torch.bfloat16
    encoder = served.real_encoder
    layers = [(l.weight, l.bias) for l in encoder.conv]
    gen = torch.Generator(device=device).manual_seed(SEED + 10)

    def cloud(b, n):
        return (torch.randn((b, n, 3), generator=gen, device=device) * 0.3).to(bf16)

    dup64, dup200, dup72, dup192 = cloud(2, 64), cloud(2, 200), cloud(2, 72), cloud(2, 192)
    cases = {
        "B64_N1024": cloud(TRAIN_BATCH, N_EXISTING),  # the training shape
        "B256_N1024": cloud(BENCH_BATCH, N_EXISTING),
        "B3_N200": cloud(3, 200),
        # 1, 2 and 5 tiles: the last cluster's second CTA has no tile
        "B1_N8": cloud(1, 8),
        "B1_N136": cloud(1, 136),
        "B5_N128": cloud(5, 128),
        # every point twice: in one tile (64 apart), across tiles (200 apart),
        # in the two CTAs of one cluster (72 apart: tiles 0 and 1) and, with
        # three tiles a cloud (192 apart), in tiles of two clusters
        "dup_B2_N128": torch.cat([dup64, dup64], dim=1).contiguous(),
        "dup_B2_N400": torch.cat([dup200, dup200], dim=1).contiguous(),
        "dup_B2_N144": torch.cat([dup72, dup72], dim=1).contiguous(),
        "dup_B2_N384": torch.cat([dup192, dup192], dim=1).contiguous(),
    }
    out = {"cases": {}}
    err = 0.0
    for name, x in cases.items():
        pooled, idx = trunk_pooled_argmax(layers, x)
        torch.cuda.synchronize()
        again = trunk_pooled_argmax(layers, x)
        check(torch.equal(again[0], pooled) and torch.equal(again[1], idx),
              f"{name}: K8 is not deterministic")
        check(pooled.shape == idx.shape == (x.shape[0], 512) and idx.dtype == torch.int32,
              f"{name}: K8 output {tuple(pooled.shape)} {idx.dtype}")
        check(torch.equal(pooled, trunk_pooled(layers, x)), f"{name}: K8 pooled differs from K4")
        own_max, own_idx = torch.max(_per_point_values(layers, x).float(), dim=1)
        check(torch.equal(pooled.float(), own_max), f"{name}: K8 pooled is not the kernel's max")
        wrong = int((idx != own_idx.int()).sum())
        check(wrong == 0, f"{name}: {wrong} K8 indices are not the first of the kernel's maxima")
        stack = _stack_reference(layers, x).float()
        want_max, want_idx = torch.max(stack, dim=1)
        top2 = stack.topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * KERNEL_ATOL
        at_idx = torch.gather(stack, 1, idx.long()[:, None, :])[:, 0]
        del stack
        res = {"max_abs_err": (pooled.float() - want_max).abs().max().item(),
               "plain_gap_at_kernel_index": (want_max - at_idx).max().item(),
               "index_equal_share": (idx == want_idx.int()).float().mean().item(),
               "clear_channels": int(clear.sum()), "channels": clear.numel()}
        print(f"K8 vs plain {name}: {json.dumps(res)}")
        check(res["max_abs_err"] <= KERNEL_ATOL, f"{name}: K8 pooled error {res['max_abs_err']}")
        check(res["plain_gap_at_kernel_index"] <= KERNEL_ATOL,
              f"{name}: K8's point is {res['plain_gap_at_kernel_index']} below the plain maximum")
        check(torch.equal(idx[clear], want_idx[clear].int()),
              f"{name}: K8 and plain indices differ where the maximum is clear")
        if name.startswith("dup"):
            check(int(idx.max()) < x.shape[1] // 2, f"{name}: a duplicate did not go to the first")
        err = max(err, res["max_abs_err"])
        out["cases"][name] = res
    out["max_abs_err"] = err
    out["times"] = {}
    for name in ("B64_N1024", "B256_N1024"):
        x = cases[name]
        t = {
            "ms": cuda_ms(lambda: trunk_pooled_argmax(layers, x)),
            "k4_ms": cuda_ms(lambda: trunk_pooled(layers, x)),
            "plain_ms": cuda_ms(lambda: trunk_pooled_argmax_reference(layers, x), iters=5),
            # the same five layers as cuBLAS bf16 matmuls + torch.max over points
            "library_ms": cuda_ms(lambda: torch.max(encoder.conv_stack(x), dim=1), iters=10),
            **trunk_bound(x.shape[0], x.shape[1], 2 + 4),
        }
        t["ratio_to_library"] = t["ms"] / t["library_ms"]
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        out["times"][name] = t
        print(f"K8 timing {name}: {json.dumps(t)}")
    return out


def head_adam_vs_plain(device) -> dict:
    """K11 vs its plain version at the head's shape, bf16 moments, count 5."""
    from hyperpocket_tpu_torch.ops.head_adam import (
        adam_scalars,
        head_adam_update,
        head_adam_update_reference,
    )

    lr = 1e-4  # the chair configs' Adam
    sc = adam_scalars(lr, 0.9, 0.999, 1e-8, 5)

    def state(seed):
        g = torch.Generator(device=device).manual_seed(seed)
        h = torch.relu(torch.randn((TRAIN_BATCH, HEAD_K), generator=g, device=device))
        dout = torch.randn((TRAIN_BATCH, HEAD_N), generator=g, device=device) * 1e-2
        p = torch.randn((HEAD_N, HEAD_K), generator=g, device=device) * 0.02
        m = (torch.randn((HEAD_N, HEAD_K), generator=g, device=device) * 1e-3).to(torch.bfloat16)
        v = (torch.rand((HEAD_N, HEAD_K), generator=g, device=device) * 1e-5).to(torch.bfloat16)
        return h.to(torch.bfloat16), dout.to(torch.bfloat16), p, m, v

    h, dout, p, m, v = state(SEED + 11)
    want = head_adam_update_reference(h, dout, p.clone(), m.clone(), v.clone(), sc)
    head_adam_update(h, dout, p, m, v, sc)
    torch.cuda.synchronize()
    again = state(SEED + 11)
    head_adam_update(*again, sc)
    check(all(torch.equal(a, b) for a, b in zip(again[2:], (p, m, v))),
          "K11 is not deterministic")
    err = (p - want[0]).abs()
    tight = 2 * torch.finfo(torch.float32).eps * want[0].abs() + 1e-5 * lr
    res = {"max_abs_err": err.max().item(), "lr": lr,
           "share_beyond_tight": (err > tight).float().mean().item()}
    for name, got, ref in (("m", m, want[1]), ("v", v, want[2])):
        ref = ref.float()
        diff = (got.float() - ref).abs()
        res[f"{name}_beyond_one_step"] = int((diff > _bf16_step(ref) + 1e-6 * ref.abs().max())
                                             .sum())
        res[f"{name}_max_abs_err"] = diff.max().item()
    print(f"K11 vs plain N={HEAD_N} K={HEAD_K} B={TRAIN_BATCH}: {json.dumps(res)}")
    check(bool(torch.isfinite(p).all()), "K11: non-finite weights")
    check(res["max_abs_err"] <= 2 * lr, f"K11: p off by {res['max_abs_err']} > 2 lr")
    check(res["share_beyond_tight"] <= HEAD_SHARE,
          f"K11: {res['share_beyond_tight']} of p beyond the tight bound")
    check(res["m_beyond_one_step"] == 0 and res["v_beyond_one_step"] == 0,
          f"K11: moments beyond one bf16 step: {res['m_beyond_one_step']}, "
          f"{res['v_beyond_one_step']}")
    entries = HEAD_N * HEAD_K
    bytes_moved = entries * (4 + 2 + 2) * 2 + (h.numel() + dout.numel()) * 2
    t = {"ms": cuda_ms(lambda: head_adam_update(h, dout, p, m, v, sc)),
         "plain_ms": cuda_ms(lambda: head_adam_update_reference(h, dout, p, m, v, sc), iters=5),
         "library_ms": None,  # no one PyTorch call forms dW and applies Adam
         **bound(bytes_moved, 2 * TRAIN_BATCH * entries / FP32_FLOPS)}
    print(f"K11 timing: {json.dumps(t)}")
    return {**res, "times": t}


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


def plain_inference(model, existing, noise, ball_points):
    """The model's inference forward with its decode on the plain route, the
    ``bmm`` chain of ``models/target_network.py``, where ``apply`` would
    launch K10: the reference that bf16 serving is held to."""
    from hyperpocket_tpu_torch.models.target_network import batched_target_network_forward

    check(model.compute_torch_dtype == torch.float32, "the plain reference runs in fp32")
    with torch.no_grad():
        latent, _, _ = model._get_latent(existing, None, None, False, noise, None)
        return batched_target_network_forward(
            model.hyper_network(latent), ball_points, list(model.target_layer_out_channels),
            model.target_use_bias)


def drive_slice(config: dict, model, model32, device, tmp: Path) -> dict:
    """The main path: infer CLI + three serving requests, with launch counts."""
    from hyperpocket_tpu_torch import serving
    from hyperpocket_tpu_torch.data.plyio import load_ply, save_ply
    from hyperpocket_tpu_torch.ops.decoder import decode_batch
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

    trunk_pooled.launches = decode_batch.launches = 0
    t0 = time.perf_counter()
    rc = serving.main(["infer", "--config", str(cfg_path), "--inputs", *plys,
                       "--out-dir", str(out_dir), "--samples", "2", "--noise-std", "0.13"])
    check(rc == 0, f"infer exited {rc}")
    infer_launches = trunk_pooled.launches
    infer_decodes = decode_batch.launches
    f = serving.make_serving_fn(model, num_output_points=N_OUT, device=device)
    outs = [f(existing, noise, seed) for seed in (11, 11, 12)]
    torch.cuda.synchronize()
    launches = trunk_pooled.launches
    decodes = decode_batch.launches
    slice_s = time.perf_counter() - t0
    check(len(f.graphs.graphs) == 1 and f.graphs.replays == 3,
          f"3 requests of one signature: {len(f.graphs.graphs)} captures, "
          f"{f.graphs.replays} replays")

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
    # each serving callable's first request of a signature runs the forward
    # twice (its warm-up, then the replay), every later request once: infer
    # (one request) 2, make_serving_fn's three requests 2 + 1 + 1
    check(infer_launches == 2, f"infer launched the trunk kernel {infer_launches} times, not 2")
    check(launches == 6, f"4 requests launched the trunk kernel {launches} times, not 6")
    check(infer_decodes == 2 and decodes == 6,
          f"4 requests launched K10 {decodes} times ({infer_decodes} in infer), not 6 (2)")

    served = model.serving_params().to(device)
    for out, seed in ((outs[0], 11), (outs[2], 12)):
        eager = eager_serving(served, existing, noise, seed)
        check(torch.equal(out, eager), f"seed {seed}: the replayed graph differs from the eager "
              f"forward by {(out - eager).abs().max().item()!r}")
    print("slice: make_serving_fn's replays bit-equal to the eager FullModel.apply (seeds 11, 12)")
    pts = generate_target_network_input_batch(
        model.target_network_input, torch.Generator(device=device).manual_seed(5), 1e9,
        SERVE_BATCH, N_OUT)
    got = served.apply(existing, None, None, 1e9, num_output_points=N_OUT, training=False,
                       noise=noise, ball_points=pts)
    want = plain_inference(model32.to(device), existing, noise, pts)
    rel_l2 = ((got - want).norm() / want.norm()).item()
    print(f"slice: bf16 serving vs the fp32 plain path (bmm chain decode) relative L2 "
          f"{rel_l2!r} (limit {REL_L2_TOL})")
    check(rel_l2 <= REL_L2_TOL, f"bf16 vs fp32 relative L2 {rel_l2} > {REL_L2_TOL}")
    return {"launches": launches, "infer_launches": infer_launches, "decode_launches": decodes,
            "rel_l2": rel_l2, "slice_s": slice_s, "plys": len(written)}


def eager_serving(served, existing, noise, seed: int) -> torch.Tensor:
    """A serving request run eagerly: ``FullModel.apply`` drawing the ball
    points from a generator seeded with the request's seed, as
    ``make_serving_fn`` draws them."""
    return served.apply(existing, None, torch.Generator(device=existing.device).manual_seed(seed),
                        1e9, num_output_points=N_OUT, training=False, noise=noise)


def both_ways(graphed, eager, batch: int) -> dict:
    """A serving callable through its graphs and eagerly, in one process:
    the graphed call's first call (warm-up, capture and replay, host ms to a
    synchronize), then clouds/s in turns (graph, eager, eager, graph), device
    ms a call (``torch.profiler``) and the busy share, device over wall."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graphed(0)
    torch.cuda.synchronize()
    out = {"first_call_ms": (time.perf_counter() - t0) * 1e3}
    rates = {"graph": [], "eager": []}
    for way in ("graph", "eager", "eager", "graph"):
        rates[way].append(clouds_per_s(graphed if way == "graph" else eager, batch))
    for way, fn in (("graph", graphed), ("eager", eager)):
        cps = [r["clouds_per_s"] for r in rates[way]]
        device = sum(_device_ms_by_kernel(fn, 5).values())
        wall = 1e3 * batch / statistics.mean(cps)
        out[way] = {"clouds_per_s": cps,
                    "window_clouds_per_s": [w for r in rates[way] for w in r["window_clouds_per_s"]],
                    "device_ms": device, "wall_ms": wall, "busy": device / wall}
    return out


def graph_stats(graphs) -> dict:
    """A serving callable's captures: pool bytes, capture and first-call ms by batch."""
    return {f"B{key[0][0][0]}": {"pool_bytes": g.pool_bytes, "capture_ms": g.capture_ms,
                                 "warmup_capture_ms": graphs.first_call_ms[key]}
            for key, g in graphs.graphs.items()}


def throughput(model, model32, device) -> dict:
    """Phase 5: make_serving_fn at B=256 and B=64 in bf16 and fp32, graphed
    and eager (``FullModel.apply``), in one process."""
    from hyperpocket_tpu_torch import serving

    gen = torch.Generator(device=device).manual_seed(3)
    out = {}
    for batch in (BENCH_BATCH, SERVE_BATCH):
        existing = torch.randn((batch, N_EXISTING, 3), generator=gen, device=device) * 0.3
        noise = torch.randn((batch, model.get_noise_size()), generator=gen, device=device) * 0.1
        for name, m in (("bf16", model), ("fp32", model32)):
            f = serving.make_serving_fn(m, num_output_points=N_OUT, device=device)
            served = m.serving_params().to(device)
            row = both_ways(lambda s: f(existing, noise, s),
                            lambda s: eager_serving(served, existing, noise, s), batch)
            row["graphs"] = graph_stats(f.graphs)
            out[f"{name}_B{batch}"] = row
            print(f"serving {name} B={batch}: clouds/s graph {row['graph']['clouds_per_s']!r} "
                  f"eager {row['eager']['clouds_per_s']!r}; device ms graph "
                  f"{row['graph']['device_ms']!r} eager {row['eager']['device_ms']!r}; busy "
                  f"graph {row['graph']['busy']!r} eager {row['eager']['busy']!r}; first call "
                  f"{row['first_call_ms']!r} ms; {json.dumps(row['graphs'])}")
            del f, served
            torch.cuda.empty_cache()
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

    def sqdist():  # one PyTorch call for the distances, without the |x|^2+|y|^2-2xy expansion
        return torch.cdist(q, k, compute_mode="donot_use_mm_for_euclid_dist") ** 2

    def library_k3():
        d = sqdist()
        return d.min(dim=2).values, d.min(dim=1).values

    # each (query, key) pair: 3 subtractions, 3 multiplications and 2 additions,
    # then a compare and a select (K1: min and index; K3: two minima), all
    # issued one instruction a lane; the reads are a few MB
    k1_bound = pair_bound(q, k, 8 * q.shape[0] * q.shape[1], 10)
    times = {
        "nn_one_direction": {"ms": cuda_ms(lambda: nn_one_direction(q, k)),
                             "plain_ms": cuda_ms(lambda: nn_one_direction_reference(q, k),
                                                 iters=3),
                             "library_ms": cuda_ms(lambda: sqdist().min(dim=2), iters=3),
                             **k1_bound},
        "nn_min_fused": {"ms": cuda_ms(lambda: nn_min_fused(q, k)),
                         "plain_ms": cuda_ms(lambda: nn_min_fused_reference(q, k), iters=3),
                         "library_ms": cuda_ms(library_k3, iters=3), **k1_bound},
    }
    print(f"nn kernel timing B=64 N=M=2048: {json.dumps(times)}")
    return {"errs": errs, "times": times}


def grad_vs_plain(gts, preds, g_got, g_want, name: str) -> dict:
    """A kernel route's Chamfer gradient w.r.t. ``preds`` against the plain autograd's.

    The plain loss finds its minima through the |x|^2 + |y|^2 - 2x.y
    expansion, whose rounding (~1e-7 here) can pick the other of two keys
    at nearly the same distance, or round both to the same value, where
    ``amin``'s gradient splits evenly between them; either moves the
    gradient of the points involved by up to twice the distance between the
    two keys. A row (a gt over the preds, or a pred over the gts) whose
    plain minimum set is not exactly the kernels' first argmin counts as a
    flip: each key in that set must be a near tie (its exact distance within
    NEAR_TIE of the kernels' minimum), and every pred no flip touches is held
    to 5e-3.
    """
    from hyperpocket_tpu_torch.ops.chamfer import batch_pairwise_sqdist
    from hyperpocket_tpu_torch.ops.nn import _sqdist_reference, nn_one_direction

    with torch.no_grad():
        preds = preds.detach()
        d1, i1 = nn_one_direction(gts, preds)
        d2, i2 = nn_one_direction(preds, gts)
        p = batch_pairwise_sqdist(gts, preds)  # (B, N, M), the plain loss's values
        set1 = p == p.amin(dim=2, keepdim=True)  # each gt's plain minimum set
        set2 = p == p.amin(dim=1, keepdim=True)  # each pred's
        del p
        own1 = torch.zeros_like(set1).scatter_(2, i1.long()[..., None], True)
        own2 = torch.zeros_like(set2).scatter_(1, i2.long()[:, None, :], True)
        off1 = (set1 != own1).any(dim=2)  # (B, N)
        off2 = (set2 != own2).any(dim=1)  # (B, M)
        exact = _sqdist_reference(gts, preds)  # the kernels' arithmetic
        gaps = torch.cat([(exact - d1[..., None])[set1 & off1[..., None]],
                          (exact - d2[:, None, :])[set2 & off2[:, None, :]]])
        del exact
        # a pred's own minimum moved, or a gt's gradient moved to or from it
        touched = off2 | ((set1 | own1) & off1[..., None]).any(dim=1)
        del set1, set2, own1, own2
        err = (g_got - g_want).abs().amax(dim=2)
        res = {"grad_err": err[~touched].max().item(), "grad_err_all": err.max().item(),
               "grad_rel_l2": ((g_got - g_want).norm() / g_want.norm()).item()}
    n_points = off1.numel() + off2.numel()
    res["argmin_flips"] = int(off1.sum() + off2.sum())
    res["max_tie_gap"] = gaps.max().item() if gaps.numel() else 0.0
    print(f"{name}: {res['argmin_flips']} argmin flips or split ties of {n_points} points, "
          f"largest exact distance gap {res['max_tie_gap']!r}; grad max_abs_err "
          f"{res['grad_err']!r} on the {int((~touched).sum())} preds no flip touches, "
          f"{res['grad_err_all']!r} over all, relative L2 {res['grad_rel_l2']!r}")
    check(bool(torch.isfinite(g_got).all()), f"{name}: non-finite Chamfer gradient")
    check(res["max_tie_gap"] <= NEAR_TIE,
          f"{name}: an argmin flip is not a near tie: gap {res['max_tie_gap']} > {NEAR_TIE}")
    check(res["argmin_flips"] <= 1e-3 * n_points, f"{name}: {res['argmin_flips']} argmin flips")
    check(res["grad_err"] <= CHAMFER_GRAD_ATOL,
          f"{name}: Chamfer gradient error {res['grad_err']} > {CHAMFER_GRAD_ATOL}")
    return res


def chamfer_vs_plain(device) -> dict:
    """The streaming Chamfer (K1 + the gather/scatter backward) vs the plain autograd:
    the value within CHAMFER_RTOL, the gradient by ``grad_vs_plain``'s rules."""
    from hyperpocket_tpu_torch.ops.chamfer import chamfer_loss
    from hyperpocket_tpu_torch.ops.nn import chamfer_loss_streaming

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
    print(f"chamfer B=64: value {got.item()!r} vs plain {want.item()!r} (relative {rel!r})")
    check(rel <= CHAMFER_RTOL, f"Chamfer value relative error {rel} > {CHAMFER_RTOL}")
    res = grad_vs_plain(gts, preds, g_got, g_want, "chamfer B=64")
    times = {
        "chamfer_value_and_grad_ms_b64": cuda_ms(lambda: value_and_grad(chamfer_loss_streaming)),
        "plain_ms": cuda_ms(lambda: value_and_grad(chamfer_loss), iters=3),
    }
    print(f"chamfer value_and_grad timing: {json.dumps(times)}")
    return {"rel": rel, **res, **times}


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
    loss = loss_fn(batch["gt"], rec)
    if mu is not None:  # HyperRec trains without the KLD
        loss = loss + kld_loss(mu, sigma, rec.shape[0])
    loss.backward()
    grads = torch.cat([p.grad.flatten() for p in params if p.grad is not None])
    model.zero_grad(set_to_none=True)
    return grads


def drive_training(config: dict, model32, device) -> dict:
    """The training slice: train steps and val steps in fp32 and bf16, with launch counts."""
    from hyperpocket_tpu_torch.ops.chamfer import chamfer_loss
    from hyperpocket_tpu_torch.ops.decoder import decode_batch, decode_batch_grad
    from hyperpocket_tpu_torch.ops.nn import chamfer_loss_grad, nn_min_fused, nn_one_direction
    from hyperpocket_tpu_torch.ops.sampling import generate_target_network_input_batch
    from hyperpocket_tpu_torch.ops.trunk_pool import trunk_pooled
    from hyperpocket_tpu_torch.train import optim, trainer
    from hyperpocket_tpu_torch.train.losses import reconstruction_loss

    tr = config["training"]
    trainer.set_matmul_precision(tr.get("matmul_precision", "highest"))
    loss_coef = float(tr["loss_coef"])
    out = {}
    kernels = (nn_one_direction, chamfer_loss_grad, nn_min_fused, trunk_pooled, decode_batch,
               decode_batch_grad)

    def reset():
        for k in kernels:
            k.launches = 0

    def counts():
        return {"nn_one_direction": nn_one_direction.launches,
                "chamfer_loss_grad": chamfer_loss_grad.launches,
                "nn_min_fused": nn_min_fused.launches, "trunk_pool": trunk_pooled.launches,
                "decode_batch": decode_batch.launches,
                "decode_batch_grad": decode_batch_grad.launches}

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
            grad_counts = counts()
            g_plain = first_step_grads(model, params, batch, balls,
                                       lambda gt, rec: loss_coef * chamfer_loss(gt, rec))
            check(grad_counts["chamfer_loss_grad"] == 1 and grad_counts["nn_one_direction"] == 0
                  and counts() == grad_counts,
                  f"the gradient check launched {grad_counts}, then {counts()}")
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
        # bf16 decodes its train steps through K10 and its backward (decode_grad_route)
        k10 = steps if dtype == "bfloat16" else 0
        check(train_counts == {"nn_one_direction": 0, "chamfer_loss_grad": steps,
                               "nn_min_fused": 0, "trunk_pool": 0, "decode_batch": k10,
                               "decode_batch_grad": k10},
              f"{dtype}: {steps} train steps launched {train_counts}")
        want_val = {"nn_one_direction": 0, "chamfer_loss_grad": 0, "nn_min_fused": 1,
                    "trunk_pool": 2 if dtype == "bfloat16" else 0, "decode_batch": 1,
                    "decode_batch_grad": 0}
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


def emd_cases(device) -> dict:
    """The clouds K6 and K7 are held to their plain versions on, by case name."""
    gen = torch.Generator(device=device).manual_seed(SEED + 7)

    def cloud(b, n):
        return torch.randn((b, n, 3), generator=gen, device=device) * 0.3

    same = cloud(4, N_EXISTING)
    return {
        "B512_1024": (cloud(512, N_EXISTING), cloud(512, N_EXISTING)),  # one eval dispatch
        "B64_2048": (cloud(TRAIN_BATCH, N_OUT), cloud(TRAIN_BATCH, N_OUT)),
        "B4_2048x1024": (cloud(4, N_OUT), cloud(4, N_EXISTING)),  # budget multiplier 2
        "B4_1024x2048": (cloud(4, N_EXISTING), cloud(4, N_OUT)),
        "B3_300x128": (cloud(3, 300), cloud(3, 128)),  # multiplier 2 by integer division
        "ragged_B3_200x136": (cloud(3, 200), cloud(3, 136)),
        "B1_1024": (cloud(1, N_EXISTING), cloud(1, N_EXISTING)),
        "coincident_B4_1024": (same, same.clone()),  # x == y: K7's 1e-20 clamp
    }


def emd_kernels_vs_plain(device) -> dict:
    """K6 and K7 vs their plain versions; both timed at the eval and the B=64 shapes."""
    from hyperpocket_tpu_torch.ops.emd import (
        match_cost_bwd_kernel,
        match_cost_bwd_reference,
        match_cost_fwd_kernel,
        match_cost_fwd_reference,
    )

    cases = emd_cases(device)
    out = {"cases": {}}
    cost_err = grad_err = 0.0
    for name, (x, y) in cases.items():
        cost = match_cost_fwd_kernel(x, y)
        gx, gy = match_cost_bwd_kernel(x, y)
        torch.cuda.synchronize()
        check(torch.equal(match_cost_fwd_kernel(x, y), cost), f"{name}: K6 is not deterministic")
        again = match_cost_bwd_kernel(x, y)
        check(torch.equal(again[0], gx) and torch.equal(again[1], gy),
              f"{name}: K7 is not deterministic")
        want = match_cost_fwd_reference(x, y)
        want_x, want_y = match_cost_bwd_reference(x, y)
        check(cost.shape == (x.shape[0],) and gx.shape == x.shape and gy.shape == y.shape,
              f"{name}: K6/K7 output shapes")
        check(all(bool(torch.isfinite(t).all()) for t in (cost, gx, gy)),
              f"{name}: non-finite K6/K7 output")
        rel = ((cost - want).abs() / want.abs()).max().item()
        res = {"cost_rel_err": rel}
        for tag, got, ref in (("gx", gx, want_x), ("gy", gy, want_y)):
            err = (got - ref).abs()
            scale = ref.abs().max().item()
            diff_l2, ref_l2 = (got - ref).norm().item(), ref.norm().item()
            res[f"{tag}_err"] = err.max().item()
            res[f"{tag}_scale"] = scale
            res[f"{tag}_rel_l2"] = diff_l2 / ref_l2 if ref_l2 else diff_l2
            # for the record: entries beyond 1e-4 of the largest, and the worst
            # entry against the elementwise rtol 1e-4 / atol 1e-6
            res[f"{tag}_share_beyond_1e-4"] = (
                err > 1e-4 * scale + EMD_GRAD_ATOL).float().mean().item()
            res[f"{tag}_elementwise_ratio"] = (err / (EMD_GRAD_ATOL + 1e-4 * ref.abs())).max().item()
            check(diff_l2 <= EMD_GRAD_REL_L2 * ref_l2 + EMD_GRAD_ATOL,
                  f"{name}: K7 {tag} relative L2 {res[f'{tag}_rel_l2']} > {EMD_GRAD_REL_L2}")
            check(res[f"{tag}_err"] <= EMD_GRAD_MAX * scale + EMD_GRAD_ATOL,
                  f"{name}: K7 {tag} max |kernel - plain| {res[f'{tag}_err']} > "
                  f"{EMD_GRAD_MAX} * {scale} + {EMD_GRAD_ATOL}")
            grad_err = max(grad_err, res[f"{tag}_err"])
        print(f"emd kernels vs plain {name}: {json.dumps(res)}")
        check(rel <= EMD_RTOL, f"{name}: K6 relative error {rel} > {EMD_RTOL}")
        cost_err = max(cost_err, (cost - want).abs().max().item())
        out["cases"][name] = res
    out["errs"] = {"emd_match_cost": cost_err, "emd_match_cost_grad": grad_err}
    out["times"] = {}
    for name in ("B512_1024", "B64_2048"):
        x, y = cases[name]
        t = {
            "emd_match_cost": {
                "ms": cuda_ms(lambda: match_cost_fwd_kernel(x, y), iters=3, windows=3),
                "plain_ms": cuda_ms(lambda: match_cost_fwd_reference(x, y), iters=1, windows=3,
                                    warmup=1)},
            "emd_match_cost_grad": {
                "ms": cuda_ms(lambda: match_cost_bwd_kernel(x, y), iters=3, windows=3),
                "plain_ms": cuda_ms(lambda: match_cost_bwd_reference(x, y), iters=1, windows=3,
                                    warmup=1)},
        }
        # 27 sweeps (K6) or 36 (K7) over every (query, key) pair of each pair of
        # clouds, ~20 issued instructions an element (PERF.md §6); no one
        # PyTorch call computes approxmatch
        elements = x.shape[0] * x.shape[1] * y.shape[1]
        for name_k, sweeps in (("emd_match_cost", 27), ("emd_match_cost_grad", 36)):
            t[name_k].update(library_ms=None,
                             **bound(4 * (x.numel() + y.numel()),
                                     sweeps * 20 * elements / FP32_LANE_RATE))
        for v in t.values():
            v["ms_per_pair"] = v["ms"] / x.shape[0]
            v["plain_ms_per_pair"] = v["plain_ms"] / x.shape[0]
        out["times"][name] = t
        print(f"emd kernel timing {name}: {json.dumps(t)}")
    return out


def emd_descent(device) -> dict:
    """The JAX package's EMD descent check through the kernels and the plain route."""
    from hyperpocket_tpu_torch.ops.emd import (
        _match_cost_bwd_plain,
        _streaming_cost,
        match_cost,
        match_cost_bwd_kernel,
        match_cost_fwd_kernel,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    x0 = torch.randn((16, 128, 3), generator=gen, device=device) * 0.3
    target = torch.randn((16, 128, 3), generator=gen, device=device) * 0.3
    scale = 16 * 128

    def through_kernels(x):  # CUDA tensors: K6 forward, K7 backward
        x.requires_grad_()
        loss = match_cost(x, target).sum() / scale
        return loss, torch.autograd.grad(loss, x)[0]

    def through_plain(x):
        return (_streaming_cost(x, target).sum() / scale,
                _match_cost_bwd_plain(x, target)[0] / scale)

    def run(value_and_grad):
        x, losses = x0.clone(), []
        for _ in range(10):
            loss, g = value_and_grad(x)
            losses.append(loss.item())
            x = (x - 0.05 * g).detach()
        return losses

    match_cost_fwd_kernel.launches = match_cost_bwd_kernel.launches = 0
    kernels = run(through_kernels)
    launches = {"emd_match_cost": match_cost_fwd_kernel.launches,
                "emd_match_cost_grad": match_cost_bwd_kernel.launches}
    plain = run(through_plain)
    rel = max(abs(a - b) / abs(b) for a, b in zip(kernels, plain))
    print(f"emd descent: losses through the kernels {kernels}, plain {plain}, largest "
          f"relative difference {rel!r} (limit {DESCENT_RTOL}); launches {launches}")
    check(all(np.isfinite(kernels)), "non-finite EMD descent loss")
    check(plain[-1] < plain[0] and kernels[-1] < kernels[0], "the EMD descent did not descend")
    check(rel <= DESCENT_RTOL, f"EMD descent trajectories differ by {rel} > {DESCENT_RTOL}")
    check(launches == {"emd_match_cost": 10, "emd_match_cost_grad": 10},
          f"10 descent steps launched {launches}")
    return {"kernels": kernels, "plain": plain, "rel": rel, "launches": launches}


def _eval_shape(rng, n: int) -> np.ndarray:
    """A random ellipsoid surface inside the unit sphere, as a completion corpus holds."""
    pts = rng.standard_normal((n, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    return (pts * rng.uniform(0.15, 0.45, 3)).astype(np.float32)


def write_eval_corpus(name: str, root: Path) -> None:
    """EVAL_OBJECTS objects of EVAL_CATEGORY in the on-disk layout ``name``'s dataset reads."""
    from hyperpocket_tpu_torch.data.plyio import save_ply

    rng = np.random.default_rng(SEED + 9)
    names = [f"smoke{i:03d}" for i in range(EVAL_OBJECTS)]
    if name == "shapenet":  # MissingShapeNet's gen test split
        for split in ("train", "val", "test"):
            (root / f"{split}.list").write_text("".join(f"{EVAL_CATEGORY}/{n}\n" for n in names))
        for side in ("right", "left", "gt"):
            (root / "test_gen" / side / EVAL_CATEGORY).mkdir(parents=True)
        for n in names:
            gt = _eval_shape(rng, N_OUT)
            order = np.argsort(gt[:, 1])
            cut = int(rng.integers(900, 1150))  # existing/missing resampled to 1024
            save_ply(root / "test_gen" / "left" / EVAL_CATEGORY / f"{n}.ply", gt[order[:cut]])
            save_ply(root / "test_gen" / "right" / EVAL_CATEGORY / f"{n}.ply", gt[order[cut:]])
            save_ply(root / "test_gen" / "gt" / EVAL_CATEGORY / f"{n}.ply", gt)
        return
    # 3D-EPN's test split: complete clouds and eight z-up partial scans per model
    (root / "slices" / "gt" / EVAL_CATEGORY).mkdir(parents=True)
    (root / "ShapeNetPointCloud" / EVAL_CATEGORY).mkdir(parents=True)
    (root / "shapenet_dim32_sdf_pc" / EVAL_CATEGORY).mkdir(parents=True)
    rows = ["id,synsetId,modelId,split"]
    for i, n in enumerate(names):
        gt = _eval_shape(rng, int(rng.integers(2400, 3600)))
        save_ply(root / "ShapeNetPointCloud" / EVAL_CATEGORY / f"{n}.ply", gt)
        for k in range(8):
            view = rng.standard_normal(3)
            scan = gt[gt @ view > 0][: int(rng.integers(600, 1400))]
            zup = scan[:, [2, 1, 0]] * np.float32([-1.0, 1.0, 1.0])  # undone by the axis swap
            save_ply(root / "shapenet_dim32_sdf_pc" / EVAL_CATEGORY / f"{n}__{k}__.ply", zup)
        rows.append(f"{i},{EVAL_CATEGORY},{n},test")
    (root / "shapenet-official-split.csv").write_text("\n".join(rows) + "\n")


def drive_experiments(model32, device, tmp: Path) -> dict:
    """``cli.main`` in experiments mode for the two eval configs, with launch counts."""
    from hyperpocket_tpu_torch import cli
    from hyperpocket_tpu_torch.convert import save_jax_npz
    from hyperpocket_tpu_torch.ops.decoder import decode_batch
    from hyperpocket_tpu_torch.ops.emd import match_cost_bwd_kernel, match_cost_fwd_kernel
    from hyperpocket_tpu_torch.ops.nn import nn_min_fused, nn_one_direction
    from hyperpocket_tpu_torch.ops.trunk_pool import trunk_pooled
    from hyperpocket_tpu_torch.train.config import get_results_dir_path

    kernels = {"emd_match_cost": match_cost_fwd_kernel, "emd_match_cost_grad": match_cost_bwd_kernel,
               "nn_min_fused": nn_min_fused, "nn_one_direction": nn_one_direction,
               "trunk_pool": trunk_pooled, "decode_batch": decode_batch}
    # JSD's entropy comes from scipy.stats, whose first import is process
    # set-up of a few seconds; it is timed here on its own, not inside the
    # first experiment that needs it
    t0 = time.perf_counter()
    import scipy.stats  # noqa: F401
    out = {"scipy_stats_import_s": time.perf_counter() - t0}
    print(f"experiments: importing scipy.stats took {out['scipy_stats_import_s']!r} s")
    for cfg_name in EVAL_CONFIGS:
        config = json.loads((ROOT / "settings" / cfg_name).read_text())
        data = tmp / cfg_name.removesuffix(".json") / "data"
        data.mkdir(parents=True)
        write_eval_corpus(config["dataset"]["name"], data)
        config["mode"] = "experiments"
        config["dataset"]["path"] = str(data)
        config["dataset"]["classes"] = [EVAL_CATEGORY]
        config["results_root"] = str(data.parent / "results")
        training = Path(get_results_dir_path(config, "training"))
        (training / "weights").mkdir(parents=True)
        (training / "metrics").mkdir(parents=True)
        save_jax_npz(str(training / "weights" / "00001_model.npz"), model32)
        np.save(training / "metrics" / "00001_val.npy", np.array([[1.0]]))

        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        with inference_forwards() as forwards:
            ctx = cli.main(config, device=device)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
        check(len(forwards) > 0, f"{cfg_name}: the experiments ran no inference forward")
        results = Path(get_results_dir_path(config, "experiments"))
        check(ctx.epoch == 1 and ctx.model.compute_dtype == "float32",
              f"{cfg_name}: restored epoch {ctx.epoch}, compute dtype {ctx.model.compute_dtype}")
        res = {"wall_s": wall_s, "timings_s": ctx.timings, "launches": launches}
        if cfg_name == "config_missing_shapenet.json":
            metrics = json.loads(
                (results / "evaluate_generativity" / "1eval_gen_by_cat.json").read_text())
            cat = metrics["chair"]
            keys = {f"{m}-{t}" for m in ("mmd(Fidelity)", "cov(Coverage)", "mmd_smp")
                    for t in ("CD", "EMD")} | {"jsd"}
            check(set(cat) == keys, f"evaluate_generativity keys {sorted(cat)}")
            check(all(np.isfinite(v) for v in cat.values()), f"non-finite metrics {cat}")
            # 16 objects x 16 completions x 16 missing halves, at 512 pairs a dispatch
            dispatches = -(-EVAL_OBJECTS ** 3 // 512)
            want = {"emd_match_cost": dispatches, "emd_match_cost_grad": 0,
                    "nn_min_fused": dispatches, "nn_one_direction": 0, "trunk_pool": 0,
                    "decode_batch": len(forwards)}
            res["metrics"] = cat
            res["dispatches"] = dispatches
        else:
            metrics = json.loads((results / "compute_mmd_tmd_uhd" / "1res.json").read_text())
            check(set(metrics) == {"MMD * 1000", "UHD * 100", "TMD * 100"},
                  f"compute_mmd_tmd_uhd keys {sorted(metrics)}")
            check(all(np.isfinite(v) for v in metrics.values()), f"non-finite metrics {metrics}")
            recs = sorted((results / "fixed").glob("*_reconstruction.npy"))
            check(len(recs) == 10 * EVAL_OBJECTS, f"fixed wrote {len(recs)} reconstructions")
            check(np.load(recs[0]).shape == (3, N_OUT), f"reconstruction {np.load(recs[0]).shape}")
            # MMD: 8 gt clouds x 64 completions a call; UHD and TMD one call each
            mmd_calls = -(-EVAL_OBJECTS // 8) * -(-len(recs) // 64)
            want = {"emd_match_cost": 0, "emd_match_cost_grad": 0,
                    "nn_min_fused": mmd_calls + 2, "nn_one_direction": 0, "trunk_pool": 0,
                    "decode_batch": len(forwards)}
            res["metrics"] = metrics
        check(launches == want, f"{cfg_name}: launches {launches}, expected {want}")
        print(f"experiments {cfg_name}: wall {wall_s!r} s, parts (s) {json.dumps(ctx.timings)}, "
              f"metrics {json.dumps(res['metrics'])}, launches {launches}")
        out[cfg_name] = res
    return out


def write_train_corpus(root: Path, n_models: int = TRAIN_MODELS) -> None:
    """A 3D-EPN train tree of ``n_models`` chairs: ``slices/gt`` (2048 points)
    and TRAIN_SAMPLES existing/missing halves of 1024 points each, cut by a
    random plane, as the slicer writes them; the split CSV labels every
    model ``train`` (3D-EPN's val split lists the same slices)."""
    from hyperpocket_tpu_torch.data.plyio import save_ply

    rng = np.random.default_rng(SEED + 12)
    for kind in ("gt", "existing", "missing"):
        (root / "slices" / kind / EVAL_CATEGORY).mkdir(parents=True)
    rows = ["id,synsetId,modelId,split"]
    for i in range(n_models):
        name = f"train{i:03d}"
        gt = _eval_shape(rng, N_OUT)
        save_ply(root / "slices" / "gt" / EVAL_CATEGORY / f"{name}.ply", gt)
        for k in range(TRAIN_SAMPLES):
            side = gt @ rng.standard_normal(3) > 0
            for kind, part in (("existing", gt[side]), ("missing", gt[~side])):
                pick = rng.choice(len(part), N_EXISTING, replace=len(part) < N_EXISTING)
                save_ply(root / "slices" / kind / EVAL_CATEGORY / f"{k}~{name}.ply", part[pick])
        rows.append(f"{i},{EVAL_CATEGORY},{name},train")
    (root / "shapenet-official-split.csv").write_text("\n".join(rows) + "\n")


def drive_cli_training(device, tmp: Path) -> dict:
    """``cli.main`` in training mode for the two chair configs, then a resume.

    Overrides: ``dataset.path`` (the corpus above), ``results_root``,
    ``training.max_epoch`` 2, ``min_save_epoch`` 0 and
    ``state_save_frequency`` 1 (so that 2 epochs save), and for the fast
    config ``compute_dtype_switch.epoch`` 1 (epoch 2 crosses to fp32); its
    bf16 epoch takes K8 with no variable set (``trunk_grad_route``). A relaunch with
    ``max_epoch`` 3 must resume at epoch 3. The model is never cut.
    """
    import importlib.util

    from hyperpocket_tpu_torch import cli
    from hyperpocket_tpu_torch.ops.adam_lowp import adam_lowp_update
    from hyperpocket_tpu_torch.ops.decoder import decode_batch, decode_batch_grad
    from hyperpocket_tpu_torch.ops.nn import chamfer_loss_grad, nn_min_fused, nn_one_direction
    from hyperpocket_tpu_torch.ops.trunk_pool import trunk_pooled, trunk_pooled_argmax
    from hyperpocket_tpu_torch.train import optim
    from hyperpocket_tpu_torch.train import trainer as trainer_mod

    kernels = {"nn_one_direction": nn_one_direction, "chamfer_loss_grad": chamfer_loss_grad,
               "nn_min_fused": nn_min_fused, "trunk_pool": trunk_pooled,
               "trunk_pool_argmax": trunk_pooled_argmax, "decode_batch": decode_batch,
               "decode_batch_grad": decode_batch_grad, "adam_lowp": adam_lowp_update}
    data = tmp / "train_data"
    t0 = time.perf_counter()
    write_train_corpus(data)
    out = {"corpus_s": time.perf_counter() - t0}
    # the CLI plots samples with matplotlib; where it is missing, the Trainer's
    # own call without plots (the JAX package's tests' call) drives the path
    plots = importlib.util.find_spec("matplotlib") is not None
    out["entry"] = "cli.main" if plots else "Trainer.run(plot_samples=False)"
    print(f"training: driven through {out['entry']}")

    epoch_s: list = []
    inner = trainer_mod.Trainer.train_epoch

    def timed(self, epoch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = inner(self, epoch)
        torch.cuda.synchronize()
        epoch_s.append((epoch, time.perf_counter() - t, len(self.last_step_losses)))
        return res

    trainer_mod.Trainer.train_epoch = timed
    try:
        for cfg_name, fused in (("config_3depn_chair.json", False),
                                ("config_3depn_chair_fast.json", True)):
            config = json.loads((ROOT / "settings" / cfg_name).read_text())
            config["dataset"]["path"] = str(data)
            config["results_root"] = str(tmp / cfg_name.removesuffix(".json"))
            tr = config["training"]
            tr.update(max_epoch=2, min_save_epoch=0, state_save_frequency=1)
            if "compute_dtype_switch" in tr:
                tr["compute_dtype_switch"]["epoch"] = 1
            res = {"runs": []}
            for max_epoch in (2, 3):
                tr["max_epoch"] = max_epoch
                for k in kernels.values():
                    k.launches = 0
                epoch_s.clear()
                t = time.perf_counter()
                with inference_forwards() as forwards:
                    if plots:
                        trainer = cli.main(config, device=device)
                    else:
                        trainer = trainer_mod.Trainer(config, device=device)
                        trainer.run(plot_samples=False)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                launches = {name: k.launches for name, k in kernels.items()}
                run = {"max_epoch": max_epoch, "start_epoch": trainer.start_epoch, "wall_s": wall,
                       "epochs": [{"epoch": e, "s": s_, "steps": n, "ms_per_step": 1e3 * s_ / n}
                                  for e, s_, n in epoch_s],
                       "train_losses": [list(map(float, r)) for r in trainer.train_losses],
                       "val_losses": [float(np.asarray(v).ravel()[0]) for v in trainer.val_losses],
                       "compute_dtype": trainer.model.compute_dtype, "launches": launches}
                print(f"training {cfg_name} max_epoch {max_epoch}: {json.dumps(run)}")
                epochs = list(range(trainer.start_epoch, max_epoch + 1))
                check(trainer.start_epoch == (1 if max_epoch == 2 else 3),
                      f"{cfg_name}: started at epoch {trainer.start_epoch}")
                check(len(trainer.train_losses) == max_epoch
                      and all(np.isfinite(r).all() for r in trainer.train_losses)
                      and all(np.isfinite(v).all() for v in trainer.val_losses),
                      f"{cfg_name}: losses {run['train_losses']} {run['val_losses']}")
                steps = [n for _, _, n in epoch_s]
                check(steps == [TRAIN_MODELS * TRAIN_SAMPLES // TRAIN_BATCH] * len(epochs),
                      f"{cfg_name}: steps per epoch {steps}")
                bf16_epochs = [e for e in epochs if fused and e <= 1]
                val_batches = -(-TRAIN_MODELS * TRAIN_SAMPLES // VAL_BATCH)
                # the fast config's Adam keeps bf16 moments: one adam_lowp launch a
                # step for each trainable tensor with a gradient (the deterministic
                # real encoder's std head has none)
                tensors = sum(p.grad is not None
                              for p in optim.trainable_parameters(trainer.model))
                want = {"nn_one_direction": 0, "chamfer_loss_grad": sum(steps),
                        "nn_min_fused": val_batches * len(epochs),
                        "trunk_pool": 2 * val_batches * len(bf16_epochs),
                        "trunk_pool_argmax": 2 * steps[0] * len(bf16_epochs),
                        # the inference forwards, and the bf16 train steps' decode
                        "decode_batch": len(forwards) + steps[0] * len(bf16_epochs),
                        "decode_batch_grad": steps[0] * len(bf16_epochs),
                        "adam_lowp": tensors * sum(steps) if fused else 0}
                check(len(forwards) >= val_batches * len(epochs),
                      f"{cfg_name}: {len(forwards)} inference forwards in {len(epochs)} epochs")
                check(launches == want, f"{cfg_name}: launches {launches}, expected {want}")
                check(trainer.model.compute_dtype == "float32",
                      f"{cfg_name}: ends in {trainer.model.compute_dtype}")
                weights = Path(trainer.weights_path)
                for e in range(1, max_epoch + 1):
                    for suffix in ("model.npz", "O.npz", "S.json"):
                        check((weights / f"{e:05}_{suffix}").exists(),
                              f"{cfg_name}: {e:05}_{suffix} missing")
                    for name in ("train", "val"):
                        check((Path(trainer.metrics_path) / f"{e:05}_{name}.npy").exists(),
                              f"{cfg_name}: metrics {e:05}_{name}.npy missing")
                check((Path(trainer.result_dir) / "last_config.json").exists()
                      and (Path(trainer.result_dir) / "log.txt").exists(),
                      f"{cfg_name}: last_config.json or log.txt missing")
                with np.load(weights / f"{max_epoch:05}_O.npz") as o:
                    run["opt_leaves"] = len(o.files)
                    moments = o["arr_3"].dtype.str
                check(moments == ("|V2" if fused else "<f4"),
                      f"{cfg_name}: moments stored as {moments}")
                res["runs"].append(run)
            out[cfg_name] = res
    finally:
        trainer_mod.Trainer.train_epoch = inner
        # the fast config's matmul_precision "high" turned TF32 on for the process
        trainer_mod.set_matmul_precision("highest")
    return out


def fused_train_step(config: dict, model32, device) -> dict:
    """3 steps of ``make_fused_train_step`` (K11 on the head) against
    ``make_train_step`` at full width, B=64, bf16 compute, from the same start
    and draws; the head's moments are fp32, as the optimizer's."""
    from hyperpocket_tpu_torch.ops.head_adam import head_adam_update
    from hyperpocket_tpu_torch.ops.sampling import generate_target_network_input_batch
    from hyperpocket_tpu_torch.train import optim, trainer

    tr = config["training"]
    loss_coef = float(tr["loss_coef"])
    batch = None
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    runs = {}
    for fused in (False, True):
        model = copy.deepcopy(model32)
        model.compute_dtype = "bfloat16"
        model = model.to(device)
        if batch is None:
            batch = train_batch(model, TRAIN_BATCH, SEED + 14, device)
            balls = [generate_target_network_input_batch(model.target_network_input, gen, 1.0,
                                                         TRAIN_BATCH, N_OUT) for _ in range(3)]
            eps = [torch.randn((TRAIN_BATCH, model.get_noise_size()), generator=gen,
                               device=device) for _ in range(3)]
        w = model.hyper_network.heads.weight
        params = [p for p in optim.trainable_parameters(model) if not (fused and p is w)]
        opt = optim.make_optimizer(tr["optimizer"], params)
        if fused:
            head = trainer.init_head_adam_state(model, "float32")
            inner = trainer.make_fused_train_step(model, opt, loss_coef)
            step = lambda *a, **k: inner(head, *a, **k)  # noqa: E731
            head_adam_update.launches = 0
        else:
            step = trainer.make_train_step(model, opt, loss_coef)
        losses = []
        t0 = time.perf_counter()
        for i in range(3):
            loss, *_ = step(batch["existing"], batch["missing"], batch["gt"], None, 1.0, N_OUT,
                            vae_eps=eps[i], ball_points=balls[i])
            losses.append(loss.item())
        torch.cuda.synchronize()
        runs["fused" if fused else "plain"] = {"losses": losses,
                                               "s": time.perf_counter() - t0,
                                               "head_w": w.detach().clone()}
        if fused:
            runs["fused"]["launches"] = head_adam_update.launches
        del model, opt
    fw, pw = runs["fused"].pop("head_w"), runs["plain"].pop("head_w")
    rel = [abs(a - b) / abs(b) for a, b in zip(runs["fused"]["losses"], runs["plain"]["losses"])]
    res = {**runs, "loss_rel": rel, "head_w_max_abs_diff": (fw - pw).abs().max().item()}
    del fw, pw
    torch.cuda.empty_cache()
    print(f"fused train step bf16 B={TRAIN_BATCH}: {json.dumps(res)}")
    check(rel[0] <= 1e-6, f"fused step: step-0 losses differ by {rel[0]}")
    check(max(rel) <= FUSED_STEP_RTOL, f"fused step: losses part by {max(rel)}")
    check(runs["fused"]["launches"] == 3, f"fused step: K11 launched {runs['fused']['launches']}")
    return res


def nn_fused_vs_plain(model32, device) -> dict:
    """Phase 16: K5 on the partial-to-completion NN path, and against its
    plain version and K1 run once each way."""
    from hyperpocket_tpu_torch import ops, serving
    from hyperpocket_tpu_torch.ops import nn
    from hyperpocket_tpu_torch.ops.chamfer import nn_backward
    from hyperpocket_tpu_torch.ops.nn import (
        nn_fused_planes,
        nn_fused_planes_reference,
        nn_min_fused,
        nn_one_direction,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 15)

    def cloud(b, n):
        return torch.randn((b, n, 3), generator=gen, device=device) * 0.3

    # the path: fp32 serving completes B=64 halves of 1024 points into 2048
    f = serving.make_serving_fn(model32, num_output_points=N_OUT, device=device)
    existing = cloud(SERVE_BATCH, N_EXISTING)
    noise = torch.randn((SERVE_BATCH, model32.get_noise_size()), generator=gen,
                        device=device) * 0.13
    completion = f(existing, noise, 15).requires_grad_()
    nn_fused_planes.launches = nn_one_direction.launches = nn.chamfer_loss_grad.launches = 0
    d1, i1, d2, i2 = ops.nn_distance_pallas(existing, completion)
    (g_nn,) = torch.autograd.grad(d1.sum() + d2.sum(), completion)
    loss = ops.chamfer_loss_auto(existing, completion)
    (g_loss,) = torch.autograd.grad(loss, completion)
    torch.cuda.synchronize()
    launches = {"nn_fused_planes": nn_fused_planes.launches,
                "nn_one_direction": nn_one_direction.launches,
                "chamfer_loss_grad": nn.chamfer_loss_grad.launches}
    print(f"K5 path: completion {tuple(completion.shape)}, launches {launches}")
    check(launches == {"nn_fused_planes": 1, "nn_one_direction": 0, "chamfer_loss_grad": 1},
          f"the N != M grad NN path launched {launches}, expected K5 and K9 once, K1 never")
    want = nn_fused_planes_reference(existing, completion.detach())
    check(all(torch.equal(g, w) for g, w in zip((d1, i1, d2, i2), want)),
          "nn_distance_pallas differs from K5's plain version")
    _, want_g = nn_backward(existing, completion.detach(), i1, i2, torch.ones_like(d1),
                            torch.ones_like(d2))
    path_err = max((g - want_g).abs().max().item() for g in (g_nn, g_loss))
    check(bool(torch.isfinite(g_nn).all()) and path_err <= 1e-5 * want_g.abs().max().item(),
          f"the K5 path's gradient is {path_err} off nn_backward's")
    check(abs(loss.item() - (d1.sum() + d2.sum()).item()) <= CHAMFER_RTOL * loss.item(),
          "chamfer_loss_auto differs from the summed K5 distances")

    dup_q, dup_k = cloud(2, 128), cloud(2, 96)
    half = cloud(4, 1001)
    cases = {
        "B64_1024x2048": (cloud(TRAIN_BATCH, N_EXISTING), cloud(TRAIN_BATCH, N_OUT)),
        "B64_2048x1024": (cloud(TRAIN_BATCH, N_OUT), cloud(TRAIN_BATCH, N_EXISTING)),
        "B64_2048x2048": (cloud(TRAIN_BATCH, N_OUT), cloud(TRAIN_BATCH, N_OUT)),
        "ragged_B3_200x136": (cloud(3, 200), cloud(3, 136)),
        "long_keys_B2_300x4500": (cloud(2, 300), cloud(2, 4500)),
        # every query and every key twice: ties both ways, the first copy wins
        "dup_both_B2_256x192": (torch.cat([dup_q, dup_q], dim=1).contiguous(),
                                torch.cat([dup_k, dup_k], dim=1).contiguous()),
        "equal_points_B2_128x96": (cloud(2, 1).expand(2, 128, 3).contiguous(),
                                   cloud(2, 1).expand(2, 96, 3).contiguous()),
        # key j again at j + ceil(M / 2), in another key split: the first copy wins
        "dup_split_B4_600x2001": (cloud(4, 600), torch.cat([half, half[:, :1000]], dim=1)),
        # M a multiple of neither the split count nor 32; one tile, many splits
        "ragged_split_B8_700x1000": (cloud(8, 700), cloud(8, 1000)),
        "one_tile_B1_64x4500": (cloud(1, 64), cloud(1, 4500)),
    }
    err = 0.0
    for name, (q, k) in cases.items():
        got = nn_fused_planes(q, k)
        torch.cuda.synchronize()
        plain = nn_fused_planes_reference(q, k)
        k1 = (*nn_one_direction(q, k), *nn_one_direction(k, q))
        for tag, g, p, o in zip(("dist1", "idx1", "dist2", "idx2"), got, plain, k1):
            check(g.dtype == p.dtype and torch.equal(g, p),
                  f"{name}: K5 {tag} differs from the plain version's at "
                  f"{int((g != p).sum())} points")
            check(torch.equal(g, o), f"{name}: K5 {tag} differs from K1's")
        if name.startswith("dup_both"):
            check(int(got[1].max()) < 96 and int(got[3].max()) < 128,
                  f"{name}: a tie did not go to the first copy")
        if name.startswith("dup_split"):
            check(int(got[1].max()) < 1001, f"{name}: a tie did not go to the first copy")
        err = max(err, (got[0] - plain[0]).abs().max().item(),
                  (got[2] - plain[2]).abs().max().item())
    print(f"K5 vs plain and K1: distances bit-equal and indices equal on {list(cases)}")
    # the planner cuts M=4500 into short splits; one or two splits make a
    # block sweep several chunks through its double buffer
    q, k = cases["long_keys_B2_300x4500"]
    want = nn_fused_planes_reference(q, k)
    for split in ((1, 4500), (2, 2272)):
        words = torch.empty(2 * (300 + 4500), dtype=torch.int64, device=device)
        dist = torch.empty(2 * (300 + 4500), dtype=torch.float32, device=device)
        idx = torch.empty(2 * (300 + 4500), dtype=torch.int32, device=device)
        nn._launch("hpcd_nn_fused_planes", q, k, dist, idx, words, split=split)
        torch.cuda.synchronize()
        check(torch.equal(dist, torch.cat([want[0].flatten(), want[2].flatten()])) and
              torch.equal(idx, torch.cat([want[1].flatten(), want[3].flatten()])),
              f"K5 with the keys in {split[0]} split(s) of {split[1]} differs from plain")
    print("K5 vs plain: bit-equal with M=4500 in 1 and 2 splits (chunks double-buffered)")

    times = {}
    for name in ("B64_1024x2048", "B64_2048x1024", "B64_2048x2048"):
        q, k = cases[name]

        def library():  # cdist without the expansion, then min and argmin both ways
            d = torch.cdist(q, k, compute_mode="donot_use_mm_for_euclid_dist") ** 2
            return d.min(dim=2), d.min(dim=1)

        b, n, m = q.shape[0], q.shape[1], k.shape[1]
        t = {
            "split": nn.nn_fused_split(b, n, m, torch.cuda.get_device_properties(
                device).multi_processor_count),
            "ms": cuda_ms(lambda: nn_fused_planes(q, k)),
            "k1_twice_ms": cuda_ms(lambda: (nn_one_direction(q, k), nn_one_direction(k, q))),
            "k3_ms": cuda_ms(lambda: nn_min_fused(q, k)),
            "plain_ms": cuda_ms(lambda: nn_fused_planes_reference(q, k), iters=3),
            "library_ms": cuda_ms(library, iters=1, windows=3, warmup=1),
            # 8 instructions for the distance, a compare and two selects each way
            **pair_bound(q, k, 8 * b * (n + m), 14),
        }
        t["ratio_to_k1_twice"] = t["ms"] / t["k1_twice_ms"]
        t["bound_share"] = t["bound_ms"] / t["ms"]
        times[name] = t
        print(f"K5 timing {name}: {json.dumps(t)}")
    return {"launches": launches, "max_abs_err": err, "times": times}


def chamfer_fused_vs_plain(device) -> dict:
    """Phase 17: ``chamfer_loss_fused`` (K9) value and gradient at the
    training shape and at 2048x1024."""
    from hyperpocket_tpu_torch.ops.chamfer import chamfer_loss, nn_backward
    from hyperpocket_tpu_torch.ops.nn import (
        chamfer_loss_fused,
        chamfer_loss_grad,
        chamfer_loss_grad_reference,
        chamfer_loss_streaming,
        nn_fused_planes,
        nn_min_fused,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 16)
    out = {"cases": {}, "times": {}}
    for name, m in (("B64_2048x2048", N_OUT), ("B64_2048x1024", N_EXISTING)):
        gts = (torch.randn((TRAIN_BATCH, N_OUT, 3), generator=gen, device=device) * 0.3)
        preds = (torch.randn((TRAIN_BATCH, m, 3), generator=gen, device=device) * 0.3)
        gts.requires_grad_()
        preds.requires_grad_()
        chamfer_loss_grad.launches = 0  # the path: value and gradient through the op
        loss = chamfer_loss_fused(gts, preds)
        ga, gb = torch.autograd.grad(loss, (gts, preds), retain_graph=True)
        ga3, gb3 = torch.autograd.grad(3.0 * loss, (gts, preds))
        torch.cuda.synchronize()
        launches = chamfer_loss_grad.launches
        check(launches == 1, f"{name}: chamfer_loss_fused launched K9 {launches} times, not 1")
        a, b = gts.detach(), preds.detach()
        with torch.no_grad():
            value = chamfer_loss_streaming(a, b)
            per_sample, _, _ = chamfer_loss_grad(a, b)
            k3 = nn_min_fused(a, b)
            k3_sums = k3[0].sum(dim=1) + k3[1].sum(dim=1)
            d1, i1, d2, i2 = nn_fused_planes(a, b)
            want_ga, want_gb = nn_backward(a, b, i1, i2, torch.ones_like(d1),
                                           torch.ones_like(d2))
            plain = chamfer_loss_grad_reference(a, b)
        res = {"launches": launches,
               "value_rel": abs(loss.item() - value.item()) / value.item(),
               "per_sample_rel": ((per_sample - k3_sums).abs() / k3_sums).max().item(),
               "ga_err_to_scale": (ga - want_ga).abs().max().item() / want_ga.abs().max().item(),
               "gb_err_to_scale": (gb - want_gb).abs().max().item() / want_gb.abs().max().item(),
               "cotangent_3x_rel": max(((g3 - 3.0 * g).abs() / (3.0 * g).abs().clamp_min(1e-30))
                                       .max().item() for g3, g in ((ga3, ga), (gb3, gb))),
               "max_abs_err": max((ga - plain[1]).abs().max().item(),
                                  (gb - plain[2]).abs().max().item())}
        print(f"K9 {name}: {json.dumps(res)}")
        check(res["value_rel"] <= CHAMFER_RTOL, f"{name}: K9 value off by {res['value_rel']}")
        check(res["per_sample_rel"] <= CHAMFER_RTOL,
              f"{name}: K9 per-sample loss off K3's sums by {res['per_sample_rel']}")
        check(max(res["ga_err_to_scale"], res["gb_err_to_scale"]) <= CHAMFER_RTOL,
              f"{name}: K9 gradients off nn_backward's by {res['ga_err_to_scale']}, "
              f"{res['gb_err_to_scale']} of their scale")
        check(res["cotangent_3x_rel"] <= 1e-6, f"{name}: 3 loss does not give 3x the gradient")
        b_plain = b.clone().requires_grad_()
        want = chamfer_loss(a, b_plain)
        (g_want,) = torch.autograd.grad(want, b_plain)
        res["plain_value_rel"] = abs(loss.item() - want.item()) / want.item()
        check(res["plain_value_rel"] <= CHAMFER_RTOL,
              f"{name}: K9 value off the plain loss by {res['plain_value_rel']}")
        res.update(grad_vs_plain(a, b, gb, g_want, f"K9 {name} vs plain autograd"))
        out["cases"][name] = res

        def value_and_grad(loss_fn):
            v = loss_fn(gts, preds)
            return v, torch.autograd.grad(v, (gts, preds))

        t = {"ms": cuda_ms(lambda: chamfer_loss_grad(a, b)),
             "k3_ms": cuda_ms(lambda: nn_min_fused(a, b)),
             "value_and_grad_ms": cuda_ms(lambda: value_and_grad(chamfer_loss_fused)),
             # phase 7's route: K1 twice (or K5) + the gather/scatter backward (K2)
             "streaming_value_and_grad_ms": cuda_ms(
                 lambda: value_and_grad(chamfer_loss_streaming)),
             "plain_ms": cuda_ms(lambda: chamfer_loss_grad_reference(a, b), iters=3),
             "library_ms": None,  # no one PyTorch call gives the loss and both fields
             **pair_bound(a, b, 4 * (TRAIN_BATCH + a.numel() + b.numel()), 14)}
        t["ratio_to_k3"] = t["ms"] / t["k3_ms"]
        t["bound_share"] = t["bound_ms"] / t["ms"]
        out["times"][name] = t
        print(f"K9 timing {name}: {json.dumps(t)}")
    out["launches"] = out["cases"]["B64_2048x2048"]["launches"]
    out["max_abs_err"] = max(c["max_abs_err"] for c in out["cases"].values())
    return out


WIDE_DECODE_CHANNELS = ((272,), (256, 256), (512, 1024, 512), (4096,), (32, 4096, 32))


def _decode_gate(got: torch.Tensor, want: torch.Tensor, bf16: bool) -> tuple[bool, float]:
    """K10's gate on small and wide cases: fp32 within 2e-5 elementwise (of the
    output's largest entry where it passes 1), bf16 within one bf16 step or
    2e-2 of the largest entry (the card tests')."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    lim = (torch.maximum(_bf16_step(want), 2e-2 * want.abs().max()) if bf16
           else 2e-5 * max(1.0, want.abs().max().item()) + 2e-5 * want.abs())
    return bool((err <= lim).all()) and bool(torch.isfinite(got).all()), err.max().item()


def decode_vs_plain(model, model32, device) -> dict:
    """Phase 18: K10 on the served model's own flat weights and ball points,
    in both roundings; the small and the wide widths; a wide bf16 model's
    inference forward."""
    from hyperpocket_tpu_torch import ops
    from hyperpocket_tpu_torch.models.full_model import FullModel
    from hyperpocket_tpu_torch.models.hyper_network import target_weight_count
    from hyperpocket_tpu_torch.models.target_network import batched_target_network_forward
    from hyperpocket_tpu_torch.ops.decoder import decode_batch_reference
    from hyperpocket_tpu_torch.ops.sampling import generate_target_network_input_batch

    channels, use_bias = model.target_layer_out_channels, model.target_use_bias
    gen = torch.Generator(device=device).manual_seed(SEED + 17)
    inputs = {}
    for dtype, net in (("bf16", model.serving_params().to(device)), ("fp32", model32)):
        cd = net.compute_torch_dtype
        for batch in (BENCH_BATCH, SERVE_BATCH):
            existing = torch.randn((batch, N_EXISTING, 3), generator=gen, device=device) * 0.3
            noise = torch.randn((batch, net.get_noise_size()), generator=gen, device=device) * 0.13
            with torch.no_grad():
                latent, _, _ = net._get_latent(existing.to(cd), None, None, False, noise.to(cd),
                                               None)
                flat = net.hyper_network(latent)
            balls = generate_target_network_input_batch(
                net.target_network_input, gen, 1e9, batch, N_OUT).to(cd)
            inputs[f"{dtype}_B{batch}"] = (flat, balls)
        del net
    ops.decode_batch.launches = 0  # each request's decode through the op, in the model's rounding
    outs = {name: ops.decode_batch(flat, balls, channels, use_bias, round_product=True)
            for name, (flat, balls) in inputs.items()}
    torch.cuda.synchronize()
    launches = ops.decode_batch.launches
    check(launches == len(inputs), f"{len(inputs)} decodes launched K10 {launches} times")

    res = {"launches": launches, "cases": {}}
    for name, (flat, balls) in inputs.items():
        r = {}
        plains = {rp: decode_batch_reference(flat, balls, channels, use_bias, rp).float()
                  for rp in (True, False)}
        # the model's (chain) rounding, then the TPU kernel's
        for key, rp in (("", True), ("tpu_rounding_", False)):
            got = (outs[name] if rp else ops.decode_batch(flat, balls, channels, use_bias)).float()
            check(got.shape == balls.shape and bool(torch.isfinite(got).all()),
                  f"{name}: K10 output {tuple(got.shape)}")
            plain = plains[rp]
            # each rounding agrees with its own plain version more often than
            # with the other's: one rounding apart stays inside the gates below
            own, other = (got == plain).float().mean().item(), (
                got == plains[not rp]).float().mean().item()
            r[f"{key}other_rounding_equal_share"] = other
            if name.startswith("bf16"):
                check(own > other, f"{name}: K10's {key or 'chain_'}rounding output equals its "
                      f"plain version in {own} of the outputs, the other rounding's in {other}")
            diff = (got - plain).abs()
            r.update({f"{key}max_abs_err": diff.max().item(),
                      f"{key}equal_share": (diff == 0).float().mean().item()})
            if name.startswith("bf16"):
                steps = diff / _bf16_step(plain)
                r[f"{key}max_bf16_steps"] = steps.max().item()
                r[f"{key}share_beyond_one_step"] = (steps > 1).float().mean().item()
            if rp:
                chain = batched_target_network_forward(flat, balls, list(channels),
                                                       use_bias).float()
                r["scale"] = plain.abs().max().item()
                r["chain_max_abs_err"] = (got - chain).abs().max().item()
                r["chain_equal_share"] = (got == chain).float().mean().item()
        # tests/test_pallas_decoder.py's bounds (2e-5 fp32, 0.05 bf16) hold on
        # outputs of order 1; the model's own weights give outputs near 60
        # and hidden values larger still, so each bound is taken relative to
        # the output's largest entry
        limit = (0.05 if name.startswith("bf16") else 2e-5) * max(1.0, r["scale"])
        for key in ("max_abs_err", "tpu_rounding_max_abs_err", "chain_max_abs_err"):
            check(r[key] <= limit, f"{name}: K10 {key} {r[key]} > {limit}")
        res["cases"][name] = r
        print(f"K10 {name}: {json.dumps(r)}")

    # rows that start off the 16-byte grid: the served requests from their
    # second and fourth sample on (a bf16 row is 38,022 bytes, an fp32 one
    # 76,044); each point's arithmetic is the same in any block
    for dtype in ("bf16", "fp32"):
        flat, balls = inputs[f"{dtype}_B{SERVE_BATCH}"]
        for first in (1, 3):
            got = ops.decode_batch(flat[first:], balls[first:], channels, use_bias,
                                   round_product=True)
            check(flat[first:].data_ptr() % 16 != 0
                  and torch.equal(got, outs[f"{dtype}_B{SERVE_BATCH}"][first:]),
                  f"K10 {dtype} on rows from sample {first} differs from the whole batch's")

    # tests/test_pallas_decoder.py's cases at B=3, N=64, and the wide widths
    # (the CUDA-core kernel in both dtypes, weights resident or streamed) at
    # B=2, N=300 with the weights scaled to keep the outputs of order 1; both
    # roundings each
    small_err, equal = {}, {}
    ops.decode_batch.launches_bf16_simt = 0
    for cases, n, scale in (((tuple(channels), (8, 16), (16,), ()), 64, 0.2),
                            (WIDE_DECODE_CHANNELS, 300, 0.05)):
        for small in cases:
            for bias in (True, False):
                w = target_weight_count(list(small), bias)
                flat = torch.randn((2 if n == 300 else 3, w), generator=gen,
                                   device=device) * scale
                pts = torch.randn((flat.shape[0], n, 3), generator=gen, device=device) * 0.5
                for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
                    args = (flat.to(dtype), pts.to(dtype), small, bias)
                    plains = {rp: decode_batch_reference(*args, rp) for rp in (False, True)}
                    for rp in (False, True):
                        got = ops.decode_batch(*args, round_product=rp)
                        ok, err = _decode_gate(got, plains[rp], name == "bf16")
                        check(ok, f"K10 {name} channels {small} bias {bias} round_product {rp}: "
                              f"off the plain version by {err}")
                        key = f"{name}_{'wide' if n == 300 else 'small'}"
                        small_err[key] = max(small_err.get(key, 0.0), err)
                        if name == "bf16":  # outputs equal to the own and the other plain rounding
                            for k, want in ((f"{key}_{rp}_own", plains[rp]),
                                            (f"{key}_{rp}_other", plains[not rp])):
                                equal[k] = equal.get(k, 0) + int((got == want).sum())
    for key in ("bf16_small", "bf16_wide"):
        for rp in (False, True):
            check(equal[f"{key}_{rp}_own"] > equal[f"{key}_{rp}_other"],
                  f"K10 {key} round_product {rp}: {equal[f'{key}_{rp}_own']} outputs equal to "
                  f"its plain version, {equal[f'{key}_{rp}_other']} to the other rounding's")
    print(f"K10 small and wide cases, bf16 outputs equal to each plain rounding: "
          f"{json.dumps(equal)}")
    wide_simt = ops.decode_batch.launches_bf16_simt
    check(wide_simt == 2 * 2 * len(WIDE_DECODE_CHANNELS),
          f"the wide bf16 cases launched the CUDA-core kernel {wide_simt} times")
    print(f"K10 small and wide cases: max_abs_err {json.dumps(small_err)}")
    res["small_err"] = small_err

    # a bf16 model with a 272-channel target layer: its inference forward
    # decodes through the CUDA-core kernel's bf16 instantiation once
    cfg = json.loads(CONFIG.read_text())["full_model"]
    cfg["compute_dtype"] = "bfloat16"
    cfg["target_network"]["layer_out_channels"] = [272]
    wide = FullModel.from_config(cfg, torch.Generator().manual_seed(SEED + 18)).to(device)
    existing = torch.randn((SERVE_BATCH, N_EXISTING, 3), generator=gen, device=device) * 0.3
    noise = torch.randn((SERVE_BATCH, wide.get_noise_size()), generator=gen, device=device) * 0.13
    balls = generate_target_network_input_batch(wide.target_network_input, gen, 1e9, SERVE_BATCH,
                                                N_OUT)
    ops.decode_batch.launches = ops.decode_batch.launches_bf16_simt = 0
    out = wide.apply(existing, None, None, 1e9, num_output_points=N_OUT, training=False,
                     noise=noise, ball_points=balls)
    torch.cuda.synchronize()
    res["wide_model_launches"] = {"decode_batch": ops.decode_batch.launches,
                                  "decode_batch_bf16_simt": ops.decode_batch.launches_bf16_simt}
    check(res["wide_model_launches"] == {"decode_batch": 1, "decode_batch_bf16_simt": 1},
          f"the 272-channel bf16 forward: K10 launches {res['wide_model_launches']}")
    with torch.no_grad():
        latent, _, _ = wide._get_latent(existing.bfloat16(), None, None, False, noise.bfloat16(),
                                        None)
        wide_flat = wide.hyper_network(latent)
    ok, err = _decode_gate(out, decode_batch_reference(wide_flat, balls.bfloat16(), [272], True,
                                                       True), True)
    check(ok and out.shape == (SERVE_BATCH, N_OUT, 3),
          f"the 272-channel bf16 forward is off the plain decode by {err}")
    res["wide_model_max_abs_err"] = err
    print(f"K10 272-channel bf16 model forward: launches {json.dumps(res['wide_model_launches'])}, "
          f"max_abs_err {err}")
    del wide

    def timing(flat, balls, chans):
        size = balls.element_size()
        macs = sum(i * o for i, o in zip((3, *chans), (*chans, 3)))
        ops_ = 2 * macs * balls.shape[0] * balls.shape[1]

        def kernel():  # the model's route: the chain's rounding
            return ops.decode_batch(flat, balls, chans, use_bias, round_product=True)

        def chain():  # the model's training decode: cuBLAS bmm + bias add + ReLU per layer
            return batched_target_network_forward(flat, balls, list(chans), use_bias)

        # ms and chain_ms by CUDA events as every kernel's row; the *_device_ms
        # beside them with the calls queued behind a sleep, without host gaps
        t = {"ms": cuda_ms(kernel), "device_ms": device_ms(kernel),
             "tpu_rounding_ms": cuda_ms(lambda: ops.decode_batch(flat, balls, chans, use_bias)),
             "chain_ms": cuda_ms(chain, iters=10),
             "chain_device_ms": device_ms(chain, iters=10),
             "plain_ms": cuda_ms(lambda: decode_batch_reference(flat, balls, chans, use_bias,
                                                                True), iters=3),
             # the inputs' type at its peak: bf16 on the tensor cores, fp32 on the CUDA cores
             **bound(size * (flat.numel() + 2 * balls.numel()),
                     ops_ / (BF16_FLOPS if size == 2 else FP32_FLOPS))}
        t["bound_share"] = t["bound_ms"] / t["ms"]
        t["device_bound_share"] = t["bound_ms"] / t["device_ms"]
        t["ratio_to_chain"] = t["ms"] / t["chain_ms"]
        return t

    res["times"] = {}
    for name, (flat, balls) in inputs.items():
        res["times"][name] = timing(flat, balls, tuple(channels))
        print(f"K10 timing {name}: {json.dumps(res['times'][name])}")
    # the bf16 CUDA-core instantiation on a served-size request at 272 channels
    flat = torch.randn((SERVE_BATCH, target_weight_count([272], True)), generator=gen,
                       device=device).bfloat16() * 0.05
    name = f"bf16_simt_272_B{SERVE_BATCH}"
    res["times"][name] = timing(flat, inputs[f"bf16_B{SERVE_BATCH}"][1], (272,))
    print(f"K10 timing {name}: {json.dumps(res['times'][name])}")
    return res


def _graph_ops(data: bytes) -> set:
    return {str(n.target) for n in torch.export.load(io.BytesIO(data)).graph.nodes}


def drive_export(model, model32, device, tmp: Path) -> dict:
    """Phase 19: the served chair model exported on the card in bf16 and fp32,
    saved, loaded back and held to ``make_serving_fn``; the artifact graphed
    and its loaded module called directly, and ``make_serving_fn``, timed at
    B=64 and B=256."""
    from hyperpocket_tpu_torch import serving
    from hyperpocket_tpu_torch.ops.decoder import decode_batch
    from hyperpocket_tpu_torch.ops.sampling import generate_target_network_input_batch
    from hyperpocket_tpu_torch.ops.trunk_pool import trunk_pooled

    gen = torch.Generator(device=device).manual_seed(SEED + 20)
    out = {}
    for name, m, tol in (("bf16", model, KERNEL_ATOL), ("fp32", model32, ARTIFACT_FP32_TOL)):
        res = {}
        for batch in (SERVE_BATCH, BENCH_BATCH):
            existing = torch.randn((batch, N_EXISTING, 3), generator=gen, device=device) * 0.3
            noise = torch.randn((batch, model.get_noise_size()), generator=gen,
                                device=device) * 0.13
            trunk_pooled.launches = decode_batch.launches = 0
            t0 = time.perf_counter()
            data = serving.export_completion(m, batch=batch, n_existing=N_EXISTING,
                                             num_output_points=N_OUT, device=device)
            export_s = time.perf_counter() - t0
            path = tmp / f"{name}_B{batch}{serving.ARTIFACT_SUFFIX}"
            path.write_bytes(data)
            t0 = time.perf_counter()
            f = serving.load_completion(path.read_bytes())
            load_s = time.perf_counter() - t0
            check(trunk_pooled.launches == 0 and decode_batch.launches == 0,
                  f"{name}: the export launched K4 or K10")
            direct = serving.make_serving_fn(m, num_output_points=N_OUT, device=device)
            row = {"export_s": export_s, "load_s": load_s, "bytes": len(data)}
            program = torch.export.load(io.BytesIO(data)).module()

            def eager(seed, program=program, meta=f.meta, existing=existing, noise=noise):
                """The loaded module called directly on the ball points of ``seed``."""
                balls = generate_target_network_input_batch(
                    meta["target_network_input"], torch.Generator(device=device).manual_seed(seed),
                    meta["epoch"], meta["batch"], meta["num_output_points"],
                    method=meta["ball_method"])
                with torch.no_grad():
                    return program(existing, noise, balls)

            row.update(both_ways(lambda s, f=f: f(existing, noise, s), eager, batch))
            row["graphs"] = graph_stats(f.graphs)
            if batch == SERVE_BATCH:
                graph = _graph_ops(data)
                has_op = "hyperpocket.trunk_pooled.default" in graph
                check(has_op == (name == "bf16"),
                      f"{name}: hyperpocket.trunk_pooled in the exported graph: {has_op}")
                check("hyperpocket.decode_batch.default" in graph,
                      f"{name}: no hyperpocket.decode_batch in the exported graph")
                want = direct(existing, noise, 31)
                # the artifact's path: three requests, replays of the graph that
                # both_ways captured above
                trunk_pooled.launches = decode_batch.launches = 0
                got = [f(existing, noise, seed) for seed in (31, 31, 32)]
                torch.cuda.synchronize()
                launches, decodes = trunk_pooled.launches, decode_batch.launches
                check(launches == (3 if name == "bf16" else 0),
                      f"{name}: 3 artifact calls launched K4 {launches} times")
                check(decodes == 3, f"{name}: 3 artifact calls launched K10 {decodes} times")
                check(torch.equal(got[0], eager(31)) and torch.equal(got[2], eager(32)),
                      f"{name}: the artifact's replays differ from its module called directly")
                check(got[0].shape == (batch, N_OUT, 3) and got[0].dtype == torch.float32
                      and bool(torch.isfinite(got[0]).all()), f"{name}: artifact output")
                check(torch.equal(got[0], got[1]) and not torch.equal(got[0], got[2]),
                      f"{name}: the artifact's seeds")
                err = ((got[0] - want).abs().max() / want.abs().max()).item()
                print(f"export {name}: artifact vs make_serving_fn, max |diff| / max |out| "
                      f"{err!r} (limit {tol}); graph holds hyperpocket.trunk_pooled: {has_op}; "
                      f"K4 / K10 launches in 3 artifact calls: {launches} / {decodes}; "
                      f"replays bit-equal to the module called directly")
                check(err <= tol, f"{name}: artifact vs make_serving_fn {err} > {tol}")
                row.update(max_rel_err=err, launches=launches, decode_launches=decodes,
                           has_trunk_op=has_op)
            rate = clouds_per_s(lambda s: direct(existing, noise, s), batch)
            row["serving_fn_clouds_per_s"] = rate["clouds_per_s"]
            row["serving_fn_window_clouds_per_s"] = rate["window_clouds_per_s"]
            print(f"artifact {name} B={batch}: clouds/s graph {row['graph']['clouds_per_s']!r} "
                  f"module called directly {row['eager']['clouds_per_s']!r} make_serving_fn "
                  f"{rate['clouds_per_s']!r}; device ms graph {row['graph']['device_ms']!r} "
                  f"eager {row['eager']['device_ms']!r}; busy graph {row['graph']['busy']!r} "
                  f"eager {row['eager']['busy']!r}; first call {row['first_call_ms']!r} ms; "
                  f"{json.dumps(row['graphs'])}")
            res[f"B{batch}"] = row
            path.unlink()
            del f, direct, data, program, eager
            torch.cuda.empty_cache()
        out[name] = res
    return out


def drive_serving_cli(model, device, tmp: Path) -> dict:
    """Phase 20: ``export``, ``infer --artifact``, ``fit-prior`` and
    ``infer --latent-prior`` through ``serving.main`` on the bf16 chair
    checkpoint and the 3D-EPN corpus of phase 14."""
    from hyperpocket_tpu_torch import serving
    from hyperpocket_tpu_torch.data.plyio import load_ply, save_ply
    from hyperpocket_tpu_torch.eval.latent_stats import (
        LatentGaussian,
        load_latent_gaussian,
        save_latent_gaussian,
    )
    from hyperpocket_tpu_torch.ops.decoder import decode_batch
    from hyperpocket_tpu_torch.ops.trunk_pool import trunk_pooled

    data = tmp / "train_data"
    write_train_corpus(data)
    config = json.loads(CONFIG.read_text())
    config["full_model"]["compute_dtype"] = "bfloat16"
    config["dataset"]["path"] = str(data)
    cfg_path = write_checkpoint(config, model, tmp)
    rng = np.random.default_rng(SEED + 21)
    plys = []
    for i, n in enumerate((3000, 1500, 2500)):
        p = tmp / f"scan{i}.ply"
        save_ply(p, rng.normal(size=(n, 3)).astype(np.float32) * 0.2 + np.float32(i))
        plys.append(str(p))
    art = str(tmp / f"chair{serving.ARTIFACT_SUFFIX}")
    prior = str(tmp / "prior.npz")
    zdim = model.get_noise_size()
    out = {}

    def run(name, argv, want_launches):
        """K4 and K10 must each launch ``want_launches`` times: an ``infer``
        of one batch loads its artifact and serves one request, the first of
        its signature, so 2 (the warm-up and the replay)."""
        trunk_pooled.launches = decode_batch.launches = 0
        t0 = time.perf_counter()
        rc = serving.main(argv)
        torch.cuda.synchronize()
        out[name] = {"s": time.perf_counter() - t0, "launches": trunk_pooled.launches,
                     "decode_launches": decode_batch.launches}
        check(rc == 0, f"serving {name} exited {rc}")
        check(trunk_pooled.launches == want_launches == decode_batch.launches,
              f"serving {name}: K4 launched {trunk_pooled.launches} times and K10 "
              f"{decode_batch.launches}, not {want_launches}")

    def completions(out_dir: Path) -> int:
        written = sorted(out_dir.glob("*.ply"))
        for p in written:
            pts = load_ply(p)
            check(pts.shape == (N_OUT, 3) and bool(np.isfinite(pts).all()),
                  f"{p.name}: {pts.shape}")
        return len(written)

    run("export", ["export", "-c", str(cfg_path), "--out", art, "--batch", str(SERVE_BATCH)], 0)
    meta = json.loads(Path(art + ".json").read_text())
    check(meta["platform"] == "cuda" and meta["batch"] == SERVE_BATCH
          and meta["noise_size"] == zdim and meta["compute_dtype"] == "bfloat16",
          f"export sidecar {meta}")
    run("infer_artifact", ["infer", "--artifact", art, "--inputs", *plys, "--out-dir",
                           str(tmp / "out"), "--samples", "2", "--noise-std", "0.13"], 2)
    out["infer_artifact"]["plys"] = completions(tmp / "out")
    check(out["infer_artifact"]["plys"] == 6, f"infer wrote {out['infer_artifact']['plys']}")
    run("fit_prior", ["fit-prior", "-c", str(cfg_path), "--out", prior, "--max-items", "128",
                      "--batch-size", str(SERVE_BATCH)], 0)
    lg = load_latent_gaussian(prior)
    check(lg.dim == zdim and bool(np.isfinite(lg.mean).all())
          and bool(np.isfinite(lg.scale_tril).all()), f"prior of dim {lg.dim}")
    run("infer_latent_prior", ["infer", "--artifact", art, "--inputs", *plys, "--out-dir",
                               str(tmp / "prior_out"), "--samples", "2", "--latent-prior",
                               prior], 2)
    out["infer_latent_prior"]["plys"] = completions(tmp / "prior_out")
    check(out["infer_latent_prior"]["plys"] == 6, "infer --latent-prior wrote no 6 PLYs")
    bad = str(tmp / "bad_prior.npz")
    save_latent_gaussian(LatentGaussian(np.zeros(zdim + 1, np.float32),
                                        np.eye(zdim + 1, dtype=np.float32)), bad)
    try:
        serving.main(["infer", "--artifact", art, "--inputs", plys[0], "--out-dir",
                      str(tmp / "bad"), "--latent-prior", bad])
        refused = False
    except SystemExit as e:
        refused = "noise_size" in str(e)
    check(refused and not (tmp / "bad").exists(), "a prior of another dim was not refused")
    out["prior_dim"] = lg.dim
    out["artifact_bytes"] = meta["bytes"]
    return out


def _write_completion3d(root: Path, n_models: int) -> None:
    """A Completion3D tree of chairs, 2048-point partial and gt clouds as h5."""
    import h5py

    rng = np.random.default_rng(SEED + 22)
    root.mkdir(parents=True)
    for split in ("train", "val", "test"):
        names = [f"{EVAL_CATEGORY}/{split}{i:03d}" for i in range(n_models)]
        (root / f"{split}.list").write_text("\n".join(names) + "\n")
        for name in names:
            gt = _eval_shape(rng, N_OUT)
            side = gt @ rng.standard_normal(3) > 0
            partial = gt[side][rng.choice(int(side.sum()), N_OUT)]
            for kind, cloud in (("partial", partial), ("gt", gt)):
                if kind == "gt" and split == "test":
                    continue
                path = root / split / kind / f"{name}.h5"
                path.parent.mkdir(parents=True, exist_ok=True)
                with h5py.File(path, "w") as fh:
                    fh.create_dataset("data", data=cloud)


def drive_hyperrec(device, tmp: Path) -> dict:
    """Phase 21: ``settings/config_completion.json``'s HyperRec model at full
    width, fp32 with TF32 off, B=66 partial and gt clouds of 2048 points:
    first-step gradients through the kernels against the plain Chamfer, 3
    train steps (K9 once a step) and a val step at B=10 (K3 once)."""
    from hyperpocket_tpu_torch.ops.chamfer import chamfer_loss
    from hyperpocket_tpu_torch.ops.decoder import decode_batch
    from hyperpocket_tpu_torch.ops.nn import chamfer_loss_grad, nn_min_fused, nn_one_direction
    from hyperpocket_tpu_torch.ops.sampling import generate_target_network_input_batch
    from hyperpocket_tpu_torch.ops.trunk_pool import trunk_pooled
    from hyperpocket_tpu_torch.train import optim, trainer
    from hyperpocket_tpu_torch.train.losses import reconstruction_loss

    config, model = build_model("float32", COMPLETION_CONFIG, SEED + 23)
    tr = config["training"]
    trainer.set_matmul_precision(tr["matmul_precision"])
    loss_coef = float(tr["loss_coef"])
    batch = int(tr["dataloader"]["train"]["batch_size"])
    val_batch = int(tr["dataloader"]["val"]["batch_size"])
    model = model.to(device)
    check(model.mode == "hyper_rec", f"config_completion.json builds {model.mode}")
    params = optim.trainable_parameters(model)
    opt = optim.make_optimizer(tr["optimizer"], params)
    train_step = trainer.make_train_step(model, opt, loss_coef)
    val_step = trainer.make_val_step(model, loss_coef)
    gen = torch.Generator(device=device).manual_seed(SEED + 24)
    partial = torch.randn((batch, N_OUT, 3), generator=gen, device=device) * 0.3
    gt = torch.randn((batch, N_OUT, 3), generator=gen, device=device) * 0.3
    kernels = {"nn_one_direction": nn_one_direction, "chamfer_loss_grad": chamfer_loss_grad,
               "nn_min_fused": nn_min_fused, "trunk_pool": trunk_pooled,
               "decode_batch": decode_batch}

    def reset():
        for k in kernels.values():
            k.launches = 0

    def counts():
        return {name: k.launches for name, k in kernels.items()}

    out = {"batch": batch, "val_batch": val_batch}
    steps = {"existing": partial, "missing": None, "gt": gt, "vae_eps": None}
    balls = generate_target_network_input_batch(model.target_network_input, gen, 1.0, batch,
                                                N_OUT)
    reset()
    g_kernel = first_step_grads(model, params, steps, balls,
                                lambda g, rec: reconstruction_loss(g, rec, loss_coef))
    grad_counts = counts()
    g_plain = first_step_grads(model, params, steps, balls,
                               lambda g, rec: loss_coef * chamfer_loss(g, rec))
    rel = ((g_kernel - g_plain).norm() / g_plain.norm()).item()
    print(f"hyperrec: first-step gradients, kernels vs plain Chamfer, relative L2 {rel!r} "
          f"(limit {STEP_GRAD_REL_L2}); launches {grad_counts}")
    check(grad_counts == {"nn_one_direction": 0, "chamfer_loss_grad": 1, "nn_min_fused": 0,
                          "trunk_pool": 0, "decode_batch": 0},
          f"hyperrec gradient check launched {grad_counts}")
    check(rel <= STEP_GRAD_REL_L2, f"hyperrec first-step gradient relative L2 {rel}")

    before = [p.detach().clone() for p in params]
    reset()  # the main path: 3 train steps, then the val step
    losses = []
    for _ in range(3):
        loss, loss_r, loss_k, rec = train_step(partial, None, gt, gen, 1.0, N_OUT)
        losses.append([loss.item(), loss_r.item(), loss_k.item()])
    torch.cuda.synchronize()
    train_counts = counts()
    reset()
    val_loss, val_rec = val_step(partial[:val_batch], None, gt[:val_batch], gen, 1.0, N_OUT)
    torch.cuda.synchronize()
    val_counts = counts()
    print(f"hyperrec: losses per step (all, rec, kld) {losses}, val loss {val_loss.item()!r}; "
          f"launches in 3 train steps {train_counts}, in the val step {val_counts}")
    check(all(np.isfinite(v) for row in losses for v in row) and losses[0][2] == 0.0,
          f"hyperrec losses {losses}")
    check(bool(torch.isfinite(val_loss)) and val_rec.shape == (val_batch, N_OUT, 3),
          "hyperrec: bad val step output")
    check(rec.shape == (batch, N_OUT, 3), f"hyperrec reconstruction {tuple(rec.shape)}")
    check(all(not torch.equal(p, b) for p, b in zip(params, before) if p.grad is not None),
          "hyperrec: a parameter with a gradient did not change")
    check(train_counts == {"nn_one_direction": 0, "chamfer_loss_grad": 3, "nn_min_fused": 0,
                           "trunk_pool": 0, "decode_batch": 0},
          f"hyperrec: 3 train steps launched {train_counts}")
    check(val_counts == {"nn_one_direction": 0, "chamfer_loss_grad": 0, "nn_min_fused": 1,
                         "trunk_pool": 0, "decode_batch": 1},
          f"hyperrec: the val step launched {val_counts}")
    out.update(first_step_grad_rel_l2=rel, losses=losses, val_loss=val_loss.item(),
               train_launches=train_counts, val_launches=val_counts)
    out["train_step"] = step_ms(lambda i: train_step(partial, None, gt, gen, 1.0, N_OUT))
    out["val_step"] = step_ms(lambda i: val_step(partial[:val_batch], None, gt[:val_batch],
                                                 gen, 1.0, N_OUT))
    print(f"hyperrec timing: train step B={batch} {json.dumps(out['train_step'])}, "
          f"val step B={val_batch} {json.dumps(out['val_step'])}")

    try:
        import h5py  # noqa: F401
    except ImportError:
        print("hyperrec: h5py is not installed here; the Completion3D reader was not run")
        out["completion3d_reader"] = "not run: no h5py"
        return out
    from hyperpocket_tpu_torch.data.base import get_datasets

    root = tmp / "completion3d"
    _write_completion3d(root, 4)
    train, val, test = get_datasets({**config["dataset"], "path": str(root)})
    existing, missing, gt_cloud, name = train[0]
    check(len(train) == 4 and len(val["chair"]) == 4 and len(test["all"]) == 4,
          f"Completion3D splits {len(train)}, {len(val['chair'])}, {len(test['all'])}")
    check(existing.shape == gt_cloud.shape == (N_OUT, 3) and missing == 0
          and name == f"{EVAL_CATEGORY}/train000", f"Completion3D item {name}")
    print(f"hyperrec: the Completion3D reader gave {len(train)} train, "
          f"{sum(len(d) for d in val.values())} val and {len(test['all'])} test items")
    out["completion3d_reader"] = "ok"
    return out


# ---------------------------------------------------------------------------
# Phases 22-25: the parallel layer over a one-rank NCCL group. NCCL takes one
# rank per card, so world sizes above 1 are proven on the CPU only (gloo,
# tests/test_torch_parallel_*.py); here every collective of the data-parallel
# code runs, over one rank.


@contextlib.contextmanager
def one_rank_group(tmp: Path):
    """A one-rank NCCL group over a file store in ``tmp``, left at the end."""
    from hyperpocket_tpu_torch.parallel import distributed

    check(distributed.initialize_multihost(f"file://{tmp}/store", 1, 0, device="cuda"),
          "the one-rank NCCL group did not come up")
    check(torch.distributed.get_backend() == "nccl",
          f"backend {torch.distributed.get_backend()}")
    try:
        yield
    finally:
        distributed.shutdown()


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms`` inside the block: K2's
    ``index_add_`` then sums in a fixed order (by default its CUDA atomics
    make two runs of one step differ in the last bits)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _counts(kernels: dict) -> dict:
    return {name: k.launches for name, k in kernels.items()}


def _reset(kernels: dict) -> None:
    for k in kernels.values():
        k.launches = 0


def drive_dp_trainer(device, tmp: Path) -> dict:
    """Phase 22: a data-parallel ``Trainer`` (``use_mesh=True``) against the
    one-process Trainer on the full-width chair config in fp32: one epoch of
    DP_TRAIN_STEPS steps at B=64 and its val epoch each, from the same seed,
    with deterministic algorithms; losses and parameters bit-equal. Step
    times of both at B=64, with the default algorithms."""
    from hyperpocket_tpu_torch.ops.decoder import decode_batch
    from hyperpocket_tpu_torch.ops.nn import nn_min_fused, nn_one_direction
    from hyperpocket_tpu_torch.train import trainer as trainer_mod

    kernels = {"nn_one_direction": nn_one_direction, "nn_min_fused": nn_min_fused,
               "decode_batch": decode_batch}
    data = tmp / "train_data"
    write_train_corpus(data, DP_TRAIN_STEPS * TRAIN_BATCH // TRAIN_SAMPLES)
    runs = {}
    with one_rank_group(tmp):
        for tag, use_mesh in (("one_process", None), ("data_parallel", True)):
            config = json.loads(CONFIG.read_text())
            config["dataset"]["path"] = str(data)
            config["results_root"] = str(tmp / tag)
            t = trainer_mod.Trainer(config, device=device, use_mesh=use_mesh)
            check((t.mesh is not None) == bool(use_mesh), f"{tag}: mesh {t.mesh}")
            _reset(kernels)
            with inference_forwards() as forwards, deterministic():
                stats, _ = t.train_epoch(1)
                torch.cuda.synchronize()
                train_counts = _counts(kernels)
                _reset(kernels)
                val, _ = t.val_epoch(1)
                torch.cuda.synchronize()
            val_counts = _counts(kernels)
            rows = np.asarray(t.last_step_losses)
            params = [p.detach().clone() for p in t.model.parameters()]
            batch = train_batch(t.model, TRAIN_BATCH, SEED + 30, device)
            timing = step_ms(lambda i, t=t: t.train_step(
                batch["existing"], batch["missing"], batch["gt"], t._next_generator(), 1.0,
                N_OUT))
            runs[tag] = {"rows": rows, "params": params, "val": float(val["total"][0]),
                         "train_launches": train_counts, "val_launches": val_counts,
                         "val_forwards": len(forwards), "step": timing}
            print(f"dp trainer {tag}: losses per step {rows.tolist()}, val {runs[tag]['val']!r}; "
                  f"launches in {len(rows)} train steps {train_counts}, in the val epoch "
                  f"{val_counts} ({len(forwards)} inference forwards); train step "
                  f"{json.dumps(timing)}")
            check(len(rows) == DP_TRAIN_STEPS and np.isfinite(rows).all(),
                  f"{tag}: {len(rows)} steps, losses {rows.tolist()}")
            check(train_counts == {"nn_one_direction": 2 * DP_TRAIN_STEPS, "nn_min_fused": 0,
                                   "decode_batch": 0}, f"{tag}: train launches {train_counts}")
            check(val_counts["nn_min_fused"] == len(forwards) == val_counts["decode_batch"] > 0,
                  f"{tag}: val launches {val_counts}, {len(forwards)} forwards")
            del t
            torch.cuda.empty_cache()
    one, dp = runs["one_process"], runs["data_parallel"]
    check(np.array_equal(one["rows"], dp["rows"]), "DP step losses differ from one process")
    check(all(torch.equal(a, b) for a, b in zip(one["params"], dp["params"])),
          "DP parameters after the epoch differ from one process")
    check(one["val"] == dp["val"], f"DP val loss {dp['val']} vs {one['val']}")
    print("dp trainer: losses, parameters and val loss bit-equal to one process")
    return {tag: {k: v for k, v in r.items() if k != "params"} | {"rows": r["rows"].tolist()}
            for tag, r in runs.items()}


def drive_ring(device, tmp: Path) -> dict:
    """Phase 23: ``chamfer_loss_point_sharded`` at B=64, 2048x2048 (K1 twice a
    hop) and 1024x2048 (K5 once a hop) against the plain ``chamfer_loss``:
    value within CHAMFER_RTOL, gradients by phase 7's near-tie rules; timed
    beside ``chamfer_loss_streaming`` and the plain loss."""
    from hyperpocket_tpu_torch.ops.chamfer import chamfer_loss
    from hyperpocket_tpu_torch.ops.nn import (
        chamfer_loss_streaming,
        nn_fused_planes,
        nn_one_direction,
    )
    from hyperpocket_tpu_torch.parallel.point_sharding import chamfer_loss_point_sharded

    kernels = {"nn_one_direction": nn_one_direction, "nn_fused_planes": nn_fused_planes}
    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    out = {}
    with one_rank_group(tmp):
        for n, m, want in ((N_OUT, N_OUT, {"nn_one_direction": 2, "nn_fused_planes": 0}),
                           (N_EXISTING, N_OUT, {"nn_one_direction": 0, "nn_fused_planes": 1})):
            name = f"B{TRAIN_BATCH}_{n}x{m}"
            gts = torch.randn((TRAIN_BATCH, n, 3), generator=gen, device=device) * 0.3
            preds = (torch.randn((TRAIN_BATCH, m, 3), generator=gen, device=device) * 0.3)
            preds.requires_grad_()

            def value_and_grad(loss_fn):
                loss = loss_fn(gts, preds)
                return loss, torch.autograd.grad(loss, preds)[0]

            _reset(kernels)
            got, g_got = value_and_grad(chamfer_loss_point_sharded)
            torch.cuda.synchronize()
            launches = _counts(kernels)
            want_v, g_want = value_and_grad(chamfer_loss)
            rel = abs(got.item() - want_v.item()) / abs(want_v.item())
            print(f"ring {name}: value {got.item()!r} vs plain {want_v.item()!r} "
                  f"(relative {rel!r}); launches {launches}")
            check(launches == want, f"ring {name}: launches {launches}, expected {want}")
            check(rel <= CHAMFER_RTOL, f"ring {name}: value relative error {rel}")
            res = grad_vs_plain(gts, preds, g_got, g_want, f"ring {name}")
            res.update(rel=rel, launches=launches,
                       ring_ms=cuda_ms(lambda: value_and_grad(chamfer_loss_point_sharded)),
                       streaming_ms=cuda_ms(lambda: value_and_grad(chamfer_loss_streaming)),
                       plain_ms=cuda_ms(lambda: value_and_grad(chamfer_loss), iters=3))
            print(f"ring {name} value_and_grad: ring {res['ring_ms']!r} ms, chamfer_loss_streaming "
                  f"{res['streaming_ms']!r} ms, plain {res['plain_ms']!r} ms")
            out[name] = res
            del gts, preds, g_got, g_want
            torch.cuda.empty_cache()
    return out


def drive_sharded_pairs(device, tmp: Path) -> dict:
    """Phase 24: ``pairwise_emd_cd_multi(mesh=)`` on one 512-pair dispatch
    (N=M=1024) against the unsharded call: every pair's CD and EMD equal; K6
    and K3 once each; both timed."""
    from hyperpocket_tpu_torch.eval.metrics import pairwise_emd_cd_multi
    from hyperpocket_tpu_torch.ops.emd import match_cost_fwd_kernel
    from hyperpocket_tpu_torch.ops.nn import nn_min_fused
    from hyperpocket_tpu_torch.parallel import make_mesh

    kernels = {"emd_match_cost": match_cost_fwd_kernel, "nn_min_fused": nn_min_fused}
    rng = np.random.default_rng(SEED + 32)
    rows = np.stack([_eval_shape(rng, N_EXISTING) for _ in range(EVAL_OBJECTS)])
    cols = np.stack([np.stack([_eval_shape(rng, N_EXISTING) for _ in range(EVAL_OBJECTS)])
                     for _ in range(2)])  # 2 x 16 x 16 = 512 pairs
    with one_rank_group(tmp):
        mesh = make_mesh(1, 1)
        want = pairwise_emd_cd_multi(rows, cols, 512, device=device)
        _reset(kernels)
        got = pairwise_emd_cd_multi(rows, cols, 512, device=device, mesh=mesh)
        launches = _counts(kernels)
        check(launches == {"emd_match_cost": 1, "nn_min_fused": 1},
              f"sharded pairs: launches {launches}")
        same = all(np.array_equal(g, w) for g, w in zip(got, want))
        print(f"sharded pairs: 512 pairs, CD and EMD equal to the unsharded call: {same}; "
              f"launches {launches}")
        check(same, "sharded pair matrices differ from the unsharded call")
        check(all(np.isfinite(g).all() for g in got), "sharded pairs: non-finite values")

        def timed(**kw):
            t0 = time.perf_counter()
            pairwise_emd_cd_multi(rows, cols, 512, device=device, **kw)
            return 1e3 * (time.perf_counter() - t0)

        timed(mesh=mesh)
        ms = {"mesh_ms": statistics.median(timed(mesh=mesh) for _ in range(5)),
              "unsharded_ms": statistics.median(timed() for _ in range(5))}
    print(f"sharded pairs wall per 512-pair call: {json.dumps(ms)}")
    return {"equal": same, "launches": launches, **ms}


def drive_dp_serving(model, device, tmp: Path) -> dict:
    """Phase 25: data-parallel ``make_serving_fn`` and a ``data_parallel=1``
    artifact in bf16 at B=256: the DP function bit-equal to ``make_serving_fn``,
    the DP artifact to the plain artifact (and within phase 19's gate of
    ``make_serving_fn``); K4 and K10 twice in each callable's first request
    (the warm-up and the replay of its graph, which holds the all-gather);
    clouds/s of each."""
    from hyperpocket_tpu_torch import serving
    from hyperpocket_tpu_torch.ops.decoder import decode_batch
    from hyperpocket_tpu_torch.ops.trunk_pool import trunk_pooled
    from hyperpocket_tpu_torch.parallel import make_mesh

    kernels = {"trunk_pool": trunk_pooled, "decode_batch": decode_batch}
    gen = torch.Generator(device=device).manual_seed(SEED + 33)
    existing = torch.randn((BENCH_BATCH, N_EXISTING, 3), generator=gen, device=device) * 0.3
    noise = torch.randn((BENCH_BATCH, model.get_noise_size()), generator=gen,
                        device=device) * 0.13
    kw = dict(batch=BENCH_BATCH, n_existing=N_EXISTING, num_output_points=N_OUT, device=device)
    out = {}
    plain = serving.make_serving_fn(model, num_output_points=N_OUT, device=device)
    plain_artifact = serving.load_completion(serving.export_completion(model, **kw))
    with one_rank_group(tmp):
        dp = serving.make_serving_fn(model, num_output_points=N_OUT, device=device,
                                     mesh=make_mesh(1, 1))
        path = tmp / f"dp1{serving.ARTIFACT_SUFFIX}"
        path.write_bytes(serving.export_completion(model, data_parallel=1, **kw))
        dp_artifact = serving.load_completion(path.read_bytes())
        check(dp_artifact.meta["data_parallel"] == 1, f"meta {dp_artifact.meta}")
        want = plain(existing, noise, 41)
        want_artifact = plain_artifact(existing, noise, 41)
        _reset(kernels)
        got = dp(existing, noise, 41)
        got_artifact = dp_artifact(existing, noise, 41)
        torch.cuda.synchronize()
        launches = _counts(kernels)
        # two first requests of their signatures: warm-up and replay each
        check(launches == {"trunk_pool": 4, "decode_batch": 4},
              f"dp serving: two requests launched {launches}")
        check(dp.graphs.replays == dp_artifact.graphs.replays == 1,
              f"dp serving: {dp.graphs.replays} / {dp_artifact.graphs.replays} replays")
        check(torch.equal(got, want), "DP make_serving_fn differs from make_serving_fn")
        check(torch.equal(got_artifact, want_artifact), "DP artifact differs from the artifact")
        err = ((got_artifact - want).abs().max() / want.abs().max()).item()
        bit_equal = torch.equal(got_artifact, want)
        print(f"dp serving bf16 B={BENCH_BATCH}: make_serving_fn(mesh=) bit-equal to "
              f"make_serving_fn; the data_parallel=1 artifact bit-equal to the artifact, "
              f"and to make_serving_fn: {bit_equal} (max |diff| / max |out| {err!r}, "
              f"limit {KERNEL_ATOL}); launches {launches}")
        check(err <= KERNEL_ATOL, f"dp artifact vs make_serving_fn {err}")
        out.update(launches=launches, artifact_vs_serving_fn_rel=err,
                   artifact_bit_equal_serving_fn=bit_equal)
        for tag, fn in (("serving_fn", plain), ("serving_fn_dp", dp),
                        ("artifact", plain_artifact), ("artifact_dp", dp_artifact)):
            rate = clouds_per_s(lambda s, fn=fn: fn(existing, noise, s), BENCH_BATCH)
            out[f"{tag}_clouds_per_s"] = rate["clouds_per_s"]
            out[f"{tag}_window_clouds_per_s"] = rate["window_clouds_per_s"]
        del dp_artifact
    print(f"dp serving clouds/s B={BENCH_BATCH}: " + json.dumps(
        {k: v for k, v in out.items() if k.endswith("clouds_per_s") and "window" not in k}))
    return out


# ---------------------------------------------------------------------------
# Phase 26: the scanned epochs (training.epoch_mode "scan", train/epoch_scan.py)


def _all_counts() -> dict:
    from hyperpocket_tpu_torch.ops import launch_counters

    return {(attr if attr != "launches" else owner.__name__): getattr(owner, attr)
            for owner, attr in launch_counters()}


def _zero_all() -> None:
    from hyperpocket_tpu_torch.ops import launch_counters

    for owner, attr in launch_counters():
        setattr(owner, attr, 0)


def _scan_trainer(name: str, cfg_name: str, dtype, mode: str, data: Path, tmp: Path, device):
    from hyperpocket_tpu_torch.train import trainer as trainer_mod

    config = json.loads((ROOT / "settings" / cfg_name).read_text())
    config["dataset"]["path"] = str(data)
    config["results_root"] = str(tmp / f"{name}_{mode}")
    tr = config["training"]
    tr["epoch_mode"] = mode
    tr["dataloader"]["train"]["drop_last"] = False
    if dtype is not None:
        tr["compute_dtype"] = dtype
    if "compute_dtype_switch" in tr:
        tr["compute_dtype_switch"]["epoch"] = 1  # epoch 2 crosses to fp32 and recaptures
    return trainer_mod.Trainer(config, device=device)


def _scan_prefix(t, loader, epoch: int) -> tuple:
    """The Trainer's scanned prefix of ``loader``'s epoch, from the loader
    (``Trainer._collect``): its steps, its (existing, missing or None, gt)
    stacks on the card and their generators."""
    prefix, _, gens = t._collect(loader, epoch)
    ex, mi, gt = t._stacked(prefix)
    return len(ex), ex, mi, gt, gens[:len(ex)]


def _epoch_timings(t_step, t_scan, epoch: int) -> dict:
    """ms per step of the step loop and of the scanned epoch over one
    epoch's uniform prefix (the batches already on the card, so no loader),
    train and val, in turns (step, scan, scan, step, step, scan); the
    capture's ms (0 where a call replays the kept graph); the device's busy
    share over one epoch each way (``torch.profiler``)."""
    n, ex, mi, gt, gens = _scan_prefix(t_scan, t_scan.train_loader, epoch)
    cat = next(iter(t_scan.val_loaders))
    vn, vex, vmi, vgt, vgens = _scan_prefix(t_scan, t_scan.val_loaders[cat], epoch)
    points = int(gt.shape[2])

    def step_epoch(_=None):
        for s in range(n):
            t_step.train_step(ex[s], None if mi is None else mi[s], gt[s], gens[s],
                              float(epoch), points)

    def scan_epoch(_=None):
        t_scan._epoch_scan_fn(ex, mi, gt, gens[:n], float(epoch), points)

    def val_step_epoch(_=None):
        for s in range(vn):
            t_step.val_step(vex[s], None if vmi is None else vmi[s], vgt[s], vgens[s],
                            float(epoch), points)

    def val_scan_epoch(_=None):
        t_scan._val_epoch_scan_fn(vex, vmi, vgt, vgens[:vn], float(epoch), points)

    def wall_ms(fn, capture_of=None) -> tuple:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        capture = (capture_of.capture_ms or 0.0) if capture_of is not None else 0.0
        return ms, capture

    out = {"train_steps": n, "val_steps": vn}
    for kind, step_fn, scan_fn, fn_obj, count in (
            ("train", step_epoch, scan_epoch, t_scan._epoch_scan_fn, n),
            ("val", val_step_epoch, val_scan_epoch, t_scan._val_epoch_scan_fn, vn)):
        turns = {"step": [], "scan": [], "scan_with_capture": [], "capture_ms": []}
        for mode in ("step", "scan", "scan", "step", "step", "scan"):
            if mode == "step":
                ms, _ = wall_ms(step_fn)
                turns["step"].append(ms / count)
            else:
                ms, capture = wall_ms(scan_fn, fn_obj)
                turns["scan"].append((ms - capture) / count)
                turns["scan_with_capture"].append(ms / count)
                turns["capture_ms"].append(capture)
        res = {f"{k}_ms_per_step": v for k, v in turns.items() if k != "capture_ms"}
        res["capture_ms"] = turns["capture_ms"]
        # busy share: the device time of one epoch over its wall time without
        # the profiler; the scan's over its replays, and with its capture
        for mode, fn in (("step", step_fn), ("scan", scan_fn)):
            kernels = _device_ms_by_kernel(lambda s, fn=fn: fn(), 1)
            device_ms = sum(kernels.values())
            check(device_ms > 0, f"scan timing: torch.profiler saw no device time ({mode})")
            res[f"{mode}_device_ms"] = device_ms
            res[f"{mode}_busy"] = device_ms / (statistics.median(turns[mode]) * count)
        res["scan_busy_with_capture"] = res["scan_device_ms"] / (
            statistics.median(turns["scan"]) * count + statistics.median(turns["capture_ms"]))
        out[kind] = res
    return out


def drive_scan_epochs(device, tmp: Path) -> dict:
    """Phase 26: ``Trainer`` with ``epoch_mode`` "scan" beside "step" on the
    full-width chair config, B=64, a 3D-EPN corpus of SCAN_MODELS chairs x 4
    halves the smoke writes (8 uniform train steps and a ragged one of 8 an
    epoch, ``drop_last`` false; val at B=60: 8 uniform batches and one of
    40), in fp32, bf16 and the fast config with K8 (its dtype switch at
    epoch 1, so epoch 2 recaptures in fp32), 2 epochs and their val epochs
    each, with deterministic algorithms: loss rows, val losses and
    parameters bit-equal; replays, scanned epochs and launches (the scan's
    are the step loop's plus one rehearsal step a new dtype); captures, one
    a dtype, the graph kept across the epochs in between. Then, with
    the default algorithms, ms per step both ways over an epoch's uniform
    prefix on the card, train and val, in turns (step, scan, scan, step,
    step, scan), the capture's ms (0 where a call replays the kept graph)
    and the busy share."""
    data = tmp / "train_data"
    write_train_corpus(data, SCAN_MODELS)
    items = SCAN_MODELS * TRAIN_SAMPLES
    train_batches, val_batches = -(-items // TRAIN_BATCH), -(-items // VAL_BATCH)
    out = {}
    cases = (("fp32", "config_3depn_chair.json", "float32", False),
             ("bf16", "config_3depn_chair.json", "bfloat16", False),
             ("bf16_k8", "config_3depn_chair_fast.json", None, True))
    for name, cfg_name, dtype, k8 in cases:
        t0 = time.perf_counter()
        try:
            trainers, runs = {}, {}
            for mode in ("step", "scan"):
                t = _scan_trainer(name, cfg_name, dtype, mode, data, tmp, device)
                rows, vals, dtypes = [], [], []
                _zero_all()
                with deterministic():
                    for epoch in (1, 2):
                        t.train_epoch(epoch)  # crosses the dtype switch at epoch 2
                        dtypes.append(t.model.compute_dtype)
                        rows.append(np.asarray(t.last_step_losses).copy())
                        vals.append(float(t.val_epoch(epoch)[0]["total"][0]))
                    torch.cuda.synchronize()
                launches = {k: v for k, v in _all_counts().items() if v}
                runs[mode] = {"rows": rows, "val": vals, "dtypes": dtypes, "launches": launches,
                              "params": [p.detach().clone() for p in t.model.parameters()],
                              "scan_invocations": t.scan_invocations,
                              "val_scan_invocations": t.val_scan_invocations}
                if mode == "scan":
                    fn, vfn = t._epoch_scan_fn, t._val_epoch_scan_fn
                    runs[mode].update(
                        replays=fn.replays, val_replays=vfn.replays,
                        rehearsals=fn.rehearsals, val_rehearsals=vfn.rehearsals,
                        captures=fn.captures, val_captures=vfn.captures,
                        reuses=fn.reuses, val_reuses=vfn.reuses,
                        launches_per_replay=fn.launches_per_replay,
                        val_launches_per_replay=vfn.launches_per_replay,
                        capture_ms=fn.capture_ms, val_capture_ms=vfn.capture_ms)
                trainers[mode] = t
            step, scan = runs["step"], runs["scan"]
            bf16_epochs = sum(d == "bfloat16" for d in step["dtypes"])
            n_dtypes = len(set(step["dtypes"]))
            # deterministic algorithms: the streaming Chamfer (K1 twice a step);
            # the fast config's Adam launches adam_lowp once a tensor with a gradient
            tensors = k8 * sum(p.grad is not None
                               for p in trainers["step"].optimizer.param_groups[0]["params"])
            # the bf16 train steps decode through K10 and its backward
            want_step = {"nn_one_direction": 2 * 2 * train_batches,
                         "nn_min_fused": 2 * val_batches,
                         "decode_batch": 2 * val_batches + train_batches * bf16_epochs,
                         "decode_batch_grad": train_batches * bf16_epochs,
                         "trunk_pooled": 2 * val_batches * bf16_epochs,
                         "trunk_pooled_argmax": 2 * train_batches * bf16_epochs,
                         "adam_lowp_update": 2 * train_batches * tensors}
            want_step = {k: v for k, v in want_step.items() if v}
            rehearsal = {"nn_one_direction": 2 * n_dtypes, "nn_min_fused": n_dtypes,
                         "decode_batch": n_dtypes + bool(bf16_epochs),
                         "decode_batch_grad": int(bool(bf16_epochs)),
                         "trunk_pooled": 2 * bool(bf16_epochs),
                         "trunk_pooled_argmax": 2 * bool(bf16_epochs),
                         "adam_lowp_update": tensors * n_dtypes}
            want_scan = {k: v + rehearsal[k] for k, v in want_step.items()}
            summary = {k: v for k, v in scan.items() if k not in ("rows", "params")}
            summary["step_launches"] = step["launches"]
            summary["rows_bit_equal"] = all(np.array_equal(a, b)
                                            for a, b in zip(scan["rows"], step["rows"]))
            summary["val_bit_equal"] = scan["val"] == step["val"]
            summary["params_bit_equal"] = all(torch.equal(a, b)
                                              for a, b in zip(scan["params"], step["params"]))
            print(f"scan {name}: dtypes {scan['dtypes']}, rows per epoch "
                  f"{[len(r) for r in scan['rows']]}, val {scan['val']} (step loop "
                  f"{step['val']}); bit-equal rows {summary['rows_bit_equal']}, val "
                  f"{summary['val_bit_equal']}, parameters {summary['params_bit_equal']}; "
                  f"scanned epochs {scan['scan_invocations']}, categories "
                  f"{scan['val_scan_invocations']}, replays {scan['replays']} + "
                  f"{scan['val_replays']}, rehearsals {scan['rehearsals']} + "
                  f"{scan['val_rehearsals']}, captures {scan['captures']} + "
                  f"{scan['val_captures']}, kept graphs replayed {scan['reuses']} + "
                  f"{scan['val_reuses']}; launches scan {scan['launches']}, step loop "
                  f"{step['launches']}; per replay {scan['launches_per_replay']} / "
                  f"{scan['val_launches_per_replay']}")
            check([len(r) for r in scan["rows"]] == [train_batches] * 2
                  and all(np.isfinite(r).all() for r in scan["rows"]),
                  f"scan {name}: rows {[r.tolist() for r in scan['rows']]}")
            check(summary["rows_bit_equal"] and summary["val_bit_equal"]
                  and summary["params_bit_equal"],
                  f"scan {name}: the scanned epochs differ from the step loop")
            check((scan["scan_invocations"], scan["val_scan_invocations"]) == (2, 2)
                  and (scan["replays"], scan["val_replays"]) == (2 * (train_batches - 1),
                                                                 2 * (val_batches - 1))
                  and (scan["rehearsals"], scan["val_rehearsals"]) == (n_dtypes, n_dtypes)
                  and (scan["captures"], scan["val_captures"]) == (n_dtypes, n_dtypes)
                  and (scan["reuses"], scan["val_reuses"]) == (2 - n_dtypes, 2 - n_dtypes),
                  f"scan {name}: {summary}")
            check(step["launches"] == want_step, f"scan {name}: step loop launched "
                  f"{step['launches']}, expected {want_step}")
            check(scan["launches"] == want_scan, f"scan {name}: scan launched "
                  f"{scan['launches']}, expected {want_scan}")
            # timing with the default algorithms, in the case's compute dtype
            for t in trainers.values():
                t.model.compute_dtype = "bfloat16" if k8 else dtype
            summary["timing"] = _epoch_timings(trainers["step"], trainers["scan"], 3)
            print(f"scan {name} timing: {json.dumps(summary['timing'])}")
        finally:
            # the fast config's matmul_precision "high" turned TF32 on for the process
            from hyperpocket_tpu_torch.train.trainer import set_matmul_precision

            set_matmul_precision("highest")
        del trainers, runs, t
        torch.cuda.empty_cache()
        summary["wall_s"] = time.perf_counter() - t0
        out[name] = summary
    return out


# ---------------------------------------------------------------------------
# Phase 27: the training path's Chamfer route (K9 against K1 twice + K2) and
# the bf16-moment Adam (``ops/adam_lowp.py``) against their previous forms.

FAST_CONFIG = ROOT / "settings" / "config_3depn_chair_fast.json"
AB_ORDER = ("a", "b", "b", "a")  # one round of turns; phase 27 runs two


@contextlib.contextmanager
def train_route(route: str):
    """The training loss's Chamfer route inside the block: "k9" is
    ``chamfer_grad_route``'s own; "streaming" sends its K9 cases to the
    streaming value and gradient (K1 twice, or K5, and K2), the route the
    port trained on before K9 was measured faster."""
    from hyperpocket_tpu_torch.ops import nn as nn_ops

    own = nn_ops.chamfer_grad_route
    if route == "streaming":
        nn_ops.chamfer_grad_route = lambda g, p: "streaming" if own(g, p) == "k9" else own(g, p)
    try:
        yield
    finally:
        nn_ops.chamfer_grad_route = own


@contextlib.contextmanager
def adam_route(route: str):
    """``AdamLowp``'s per-tensor update inside the block: "kernel"
    (``adam_lowp_update``, one launch a tensor) or "plain" (the torch
    arithmetic, ``adam_lowp_update_reference``, on the card)."""
    from hyperpocket_tpu_torch.ops.adam_lowp import adam_lowp_update_reference
    from hyperpocket_tpu_torch.train import optim

    own = optim.adam_lowp_update
    if route == "plain":
        optim.adam_lowp_update = adam_lowp_update_reference
    try:
        yield
    finally:
        optim.adam_lowp_update = own


@contextlib.contextmanager
def trunk_route(route: str):
    """The encoder's training trunk inside the block: "k8" is
    ``trunk_grad_route``'s own on the card; "sparse" sends its K8 cases to
    ``_ConvPooledSparse`` (the cuBLAS bf16 chain + ``torch.max``), the
    route the card trained on before K8 became its default."""
    from hyperpocket_tpu_torch.models import encoder

    own = encoder.trunk_grad_route
    if route == "sparse":
        encoder.trunk_grad_route = lambda x: "sparse" if own(x) == "k8" else own(x)
    try:
        yield
    finally:
        encoder.trunk_grad_route = own


def _ab_turns(measure, routes: dict, rounds: int = 2) -> dict:
    """``measure()`` under each of the two routes in turns, A B B A per round:
    ``routes`` maps a name to the context manager that sets it up."""
    (a, ctx_a), (b, ctx_b) = routes.items()
    turns = {a: [], b: []}
    for _ in range(rounds):
        for which in AB_ORDER:
            name, ctx = (a, ctx_a) if which == "a" else (b, ctx_b)
            with ctx():
                turns[name].append(measure())
    return turns


def adam_lowp_vs_plain(model32, device) -> dict:
    """The adam_lowp kernel against its plain version on the chair model's
    44 trainable tensors (43.3 M values): three steps of ``AdamLowp`` with
    random gradients, each kernel launch bit-equal to the plain torch
    arithmetic (parameters and both moments) for every dtype pair it
    instantiates, Adam and AdamW with weight decay, and the fast config's
    Adam (no decay) with bf16 and fp16 moments eagerly and replayed in a
    captured step. A step's updates timed on the device beside the plain
    arithmetic and torch's fused Adam with fp32 moments, and ``step``'s
    wall time (its bias corrections included)."""
    from hyperpocket_tpu_torch.ops.adam_lowp import adam_lowp_update, adam_lowp_update_reference
    from hyperpocket_tpu_torch.train import optim

    shapes = [tuple(p.shape) for p in optim.trainable_parameters(model32)]
    lr = 1e-4

    def tensors(dtype, seed):
        g = torch.Generator(device=device).manual_seed(seed)
        ps = [(torch.randn(s, generator=g, device=device) * 0.02).to(dtype) for s in shapes]
        grads = [[(torch.randn(s, generator=g, device=device)
                   * 10.0 ** torch.randint(-6, 1, s, generator=g, device=device)).to(dtype)
                  for s in shapes] for _ in range(3)]
        return ps, grads

    def run(dtype, md, kind, wd, route, graphed, seed):
        ps, grads = tensors(dtype, seed)
        params = [torch.nn.Parameter(p) for p in ps]
        opt = optim.make_optimizer({"type": kind, "hyperparams": {
            "lr": lr, "weight_decay": wd, "moment_dtype": md}}, params)
        with adam_route(route):
            if not graphed:
                for step_grads in grads:
                    for p, g in zip(params, step_grads):
                        p.grad = g.clone()
                    opt.step()
            else:
                for p, g in zip(params, grads[0]):
                    p.grad = g.clone()
                # the first step eagerly creates the state, then one capture
                opt.step()
                graph = torch.cuda.CUDAGraph()
                torch.cuda.synchronize()
                with torch.cuda.graph(graph):
                    opt.step()
                for step_grads in grads[1:]:
                    for p, g in zip(params, step_grads):
                        p.grad.copy_(g)
                    graph.replay()
        torch.cuda.synchronize()
        return [(p.detach(), opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"]) for p in params]

    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    cases = [(dt, md, kind, 1e-2, False) for dt in (f32, bf16, f16) for md in ("bfloat16",
             "float16", "float32") for kind in ("Adam", "AdamW")]
    cases += [(f32, md, "Adam", 0.0, graphed) for md in ("bfloat16", "float16")
              for graphed in (False, True)]
    out = {"cases": {}, "tensors": len(shapes), "values": sum(math.prod(s) for s in shapes)}
    for i, (dt, md, kind, wd, graphed) in enumerate(cases):
        name = (f"{str(dt).removeprefix('torch.')}_{md}_{kind}_wd{wd}"
                + ("_graphed" if graphed else ""))
        adam_lowp_update.launches = 0
        got = run(dt, md, kind, wd, "kernel", graphed, SEED + 40 + i)
        launches = adam_lowp_update.launches
        want = run(dt, md, kind, wd, "plain", False, SEED + 40 + i)
        equal = all(torch.equal(a, b) for g, w in zip(got, want) for a, b in zip(g, w))
        diff = max((a.float() - b.float()).abs().max().item()
                   for g, w in zip(got, want) for a, b in zip(g, w))
        out["cases"][name] = {"bit_equal": equal, "max_abs_err": diff, "launches": launches}
        del got, want
        check(equal, f"adam_lowp {name}: kernel differs from the plain version by {diff}")
        # graphed: the eager first step and the capture's records (a bare graph's
        # replays count nothing)
        want_launches = len(shapes) * (2 if graphed else 3)
        check(launches == want_launches,
              f"adam_lowp {name}: {launches} launches, expected {want_launches}")
    print(f"adam_lowp vs plain: {len(cases)} cases bit-equal over 3 steps "
          f"({json.dumps(out['cases'])})")
    # one step's updates over the model's tensors at the fast config's dtypes, device
    # time (the launches queued behind a sleep): the kernel once a tensor, the plain
    # arithmetic, and torch's fused Adam with fp32 moments, the nearest one call
    ps, grads = tensors(f32, SEED + 39)
    params = [torch.nn.Parameter(p) for p in ps]
    for p, g in zip(params, grads[0]):
        p.grad = g
    opt = optim.make_optimizer({"type": "Adam", "hyperparams": {
        "lr": lr, "moment_dtype": "bfloat16"}}, params)
    fused = torch.optim.Adam(params, lr=lr, fused=True)
    opt.step(), fused.step()
    states = [opt.state[p] for p in params]
    bc1, bc2 = (torch.full((), 1 - b ** 3, device=device) for b in (0.9, 0.999))

    def updates(update):
        for p, st in zip(params, states):
            update(p, p.grad, st["exp_avg"], st["exp_avg_sq"], bc1, bc2, lr=lr, b1=0.9, b2=0.999,
                   eps=1e-8)

    values = out["values"]
    slow = 60_000_000  # ~30 ms: longer than queueing a step's ~900 plain launches
    # fp32 p and g read, p written, bf16 mu and nu read and written: 20 bytes a value
    t = {"ms": device_ms(lambda: updates(adam_lowp_update), iters=10, sleep_cycles=slow),
         "plain_ms": device_ms(lambda: updates(adam_lowp_update_reference), iters=2,
                               sleep_cycles=slow),
         "library_ms": device_ms(fused.step, iters=10, sleep_cycles=slow),
         "step_wall_ms": cuda_ms(opt.step),
         **bound(20 * values, 30 * values / FP32_FLOPS)}
    t["bound_share"] = t["bound_ms"] / t["ms"]
    out["times"] = t
    out["max_abs_err"] = max(c["max_abs_err"] for c in out["cases"].values())
    print(f"adam_lowp timing, {len(shapes)} tensors, {values} values a step: {json.dumps(t)}")
    del params, opt, fused, ps, grads
    torch.cuda.empty_cache()
    return out


def k9_replays_as_eager(device) -> dict:
    """``chamfer_loss_auto``'s K9 value and gradient captured in a CUDA graph
    and replayed on new inputs: within K9's gate of the eager call."""
    from hyperpocket_tpu_torch.ops.nn import chamfer_loss_auto, chamfer_loss_grad

    gen = torch.Generator(device=device).manual_seed(SEED + 60)
    gts = torch.randn((TRAIN_BATCH, N_OUT, 3), generator=gen, device=device) * 0.3
    preds = (torch.randn((TRAIN_BATCH, N_OUT, 3), generator=gen, device=device) * 0.3)
    preds.requires_grad_()

    def value_and_grad():
        loss = chamfer_loss_auto(gts, preds)
        return loss.detach(), torch.autograd.grad(loss, preds)[0]

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        value_and_grad()  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = chamfer_loss_grad.launches
    with torch.cuda.graph(graph):
        loss_s, grad_s = value_and_grad()
    check(chamfer_loss_auto.route == "k9", f"the captured loss took {chamfer_loss_auto.route}")
    errs = []
    for s in range(2):
        with torch.no_grad():
            gts.copy_(torch.randn(gts.shape, generator=gen, device=device) * 0.3)
            preds.copy_(torch.randn(preds.shape, generator=gen, device=device) * 0.3)
        graph.replay()
        loss_e, grad_e = value_and_grad()
        torch.cuda.synchronize()
        errs.append({"value_rel": abs(loss_s.item() - loss_e.item()) / loss_e.item(),
                     "grad_err_to_scale": ((grad_s - grad_e).abs().max()
                                           / grad_e.abs().max()).item()})
    res = {"replays": errs, "launches_in_capture": chamfer_loss_grad.launches - before}
    print(f"K9 replayed against eager: {json.dumps(res)}")
    check(all(e["value_rel"] <= CHAMFER_RTOL and e["grad_err_to_scale"] <= CHAMFER_RTOL
              for e in errs), f"K9's replays differ from eager: {errs}")
    return res


def _route_model(config_path: Path, dtype: str, seed: int, device):
    """A step function of a config's model at full width, with its optimizer."""
    from hyperpocket_tpu_torch.train import optim, trainer

    config, model = build_model(dtype, config_path, seed)
    tr = config["training"]
    trainer.set_matmul_precision(tr.get("matmul_precision", "highest"))
    model = model.to(device)
    opt = optim.make_optimizer(tr["optimizer"], optim.trainable_parameters(model))
    return model, trainer.make_train_step(model, opt, float(tr["loss_coef"]))


def drive_train_routes(device, tmp: Path, route_ctx=train_route, adam_ctx=adam_route,
                       rounds: int = 2) -> dict:
    """Phase 27's A/B: the previous training path ("parent": the streaming
    Chamfer value and gradient, and on the fast config the plain
    ``AdamLowp`` loop) against this one ("change": K9 and the adam_lowp
    kernel), in turns (A B B A, ``rounds`` times) in one process: the loss's
    value and gradient alone at B=64, 2048x2048 and 2048x1024 (device ms,
    CUDA events); train steps at B=64 in the step loop (host ms a step
    over windows that end in a synchronize) for the chair config in fp32
    and bf16 and the fast config (bf16, bf16 moments, K8), and HyperRec's at
    B=66; the same three chair cases as scanned epochs (phase 26's Trainer,
    an epoch's uniform prefix on the card: the step loop's and the scan's
    ms a step, the capture left out). Then, on the change, the fast config's
    scanned epoch with K8 against the cuBLAS trunk, the busy share and the
    launches of one scanned epoch each way."""
    from hyperpocket_tpu_torch.train import trainer as trainer_mod
    from hyperpocket_tpu_torch.train.losses import reconstruction_loss

    def both(route, adam=None):
        @contextlib.contextmanager
        def ctx():
            with route_ctx(route), (adam_ctx(adam) if adam else contextlib.nullcontext()):
                yield
        return ctx

    routes = {"parent": both("streaming"), "change": both("k9")}
    fast_routes = {"parent": both("streaming", "plain"), "change": both("k9", "kernel")}
    out = {"loss": {}, "step_loop": {}, "scan": {}}
    gen = torch.Generator(device=device).manual_seed(SEED + 50)
    for name, m in (("2048x2048", N_OUT), ("2048x1024", N_EXISTING)):
        gts = torch.randn((TRAIN_BATCH, N_OUT, 3), generator=gen, device=device) * 0.3
        preds = (torch.randn((TRAIN_BATCH, m, 3), generator=gen, device=device) * 0.3)
        preds.requires_grad_()

        def value_and_grad():
            torch.autograd.grad(reconstruction_loss(gts, preds, 1.0), preds)

        out["loss"][name] = _ab_turns(lambda: cuda_ms(value_and_grad, windows=3), routes, rounds)
        print(f"train routes: Chamfer value and gradient B={TRAIN_BATCH} {name}, ms: "
              f"{json.dumps(out['loss'][name])}")
    try:
        for case, cfg, dtype, ab in (("fp32", CONFIG, "float32", routes),
                                     ("bf16", CONFIG, "bfloat16", routes),
                                     ("fast", FAST_CONFIG, "bfloat16", fast_routes),
                                     ("hyperrec", COMPLETION_CONFIG, "float32", routes)):
            model, step = _route_model(cfg, dtype, SEED + 51, device)
            batch = 66 if case == "hyperrec" else TRAIN_BATCH
            b = train_batch(model, batch, SEED + 52, device)
            missing = None if case == "hyperrec" else b["missing"]
            existing = b["gt"] if case == "hyperrec" else b["existing"]

            def one_step(i, step=step, existing=existing, missing=missing, b=b):
                step(existing, missing, b["gt"], gen, 1.0, N_OUT)

            out["step_loop"][case] = _ab_turns(lambda: step_ms(one_step)["ms"], ab, rounds)
            print(f"train routes: step loop {case} B={batch}, ms a step: "
                  f"{json.dumps(out['step_loop'][case])}")
            del model, step, b
            torch.cuda.empty_cache()
    finally:
        trainer_mod.set_matmul_precision("highest")

    data = tmp / "train_data"
    write_train_corpus(data, SCAN_MODELS)
    for case, cfg_name, dtype, ab in (("fp32", "config_3depn_chair.json", "float32", routes),
                                      ("bf16", "config_3depn_chair.json", "bfloat16", routes),
                                      ("fast", "config_3depn_chair_fast.json", None,
                                       fast_routes)):
        try:
            t = _scan_trainer(f"routes_{case}", cfg_name, dtype, "scan", data, tmp, device)
            res = _scan_ab(t, ab, rounds)
            if case == "fast":
                res.update(_fast_extras(t, fast_routes, rounds))
        finally:
            trainer_mod.set_matmul_precision("highest")
        out["scan"][case] = res
        print(f"train routes: scanned epoch {case}: {json.dumps(res)}")
        del t
        torch.cuda.empty_cache()
    return out


def _scan_ab(t, ab: dict, rounds: int) -> dict:
    """One Trainer's epoch-1 uniform prefix on the card: ms a step of the
    step loop and of the scanned epoch (its capture left out) under each
    route in turns."""
    n, ex, mi, gt, gens = _scan_prefix(t, t.train_loader, 1)
    points = int(gt.shape[2])
    fn = t._epoch_scan_fn

    def loop():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(n):
            t.train_step(ex[s], None if mi is None else mi[s], gt[s], gens[s], 1.0, points)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    def scan():  # captures under the route in force: the kept graph goes first
        fn.release()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(ex, mi, gt, gens[:n], 1.0, points)
        torch.cuda.synchronize()
        return (1e3 * (time.perf_counter() - t0) - (fn.capture_ms or 0.0)) / n

    loop(), scan()  # the optimizer's state and the scan's rehearsal off the clock
    return {"steps": n, "step_loop_ms": _ab_turns(loop, ab, rounds),
            "scan_ms": _ab_turns(scan, ab, rounds)}


def _fast_extras(t, fast_routes: dict, rounds: int) -> dict:
    """The fast config's scanned epoch on the change: with K8 against the
    cuBLAS trunk (``trunk_route``) in turns; each way's busy share
    (device time over wall, ``torch.profiler``), the adam_lowp kernel's
    device ms a step, and the launches of a replay, parent and change."""
    n, ex, mi, gt, gens = _scan_prefix(t, t.train_loader, 1)
    points = int(gt.shape[2])
    fn = t._epoch_scan_fn

    def scan():  # captures under the route in force: the kept graph goes first
        fn.release()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(ex, mi, gt, gens[:n], 1.0, points)
        torch.cuda.synchronize()
        return (1e3 * (time.perf_counter() - t0) - (fn.capture_ms or 0.0)) / n

    @contextlib.contextmanager
    def trunk(k8: bool):
        with fast_routes["change"](), trunk_route("k8" if k8 else "sparse"):
            yield

    res = {"k8_ms": _ab_turns(scan, {"k8": lambda: trunk(True), "cublas": lambda: trunk(False)},
                              rounds)}
    for name, ctx in fast_routes.items():
        with ctx():
            wall = statistics.median([scan() for _ in range(3)])
            kernels = _device_ms_by_kernel(lambda s: fn(ex, mi, gt, gens[:n], 1.0, points), 1)
            per_replay = fn.launches_per_replay
        device = sum(kernels.values())
        res[f"{name}_busy"] = device / n / wall
        res[f"{name}_device_ms_a_step"] = device / n
        res[f"{name}_adam_lowp_device_ms_a_step"] = sum(
            v for k, v in kernels.items() if "adam_lowp_kernel" in k) / n
        res[f"{name}_launches_per_replay"] = per_replay
    return res


def _same_rows(a: np.ndarray, b: np.ndarray) -> bool:
    """``a`` and ``b`` hold the same rows (as multisets)."""
    return np.array_equal(a[np.lexsort(a.T)], b[np.lexsort(b.T)])


def drive_slicer(device) -> dict:
    """Phase 28: ``slice_point_cloud_device`` on the card against its CPU run,
    then timed from a card generator beside the host slicer."""
    import warnings

    from hyperpocket_tpu_torch.data.slicer import slice_point_cloud, slice_point_cloud_device

    rng = np.random.default_rng(SEED + 28)
    clouds = np.stack([_eval_shape(rng, N_OUT) for _ in range(SLICE_CLOUDS)])
    draws = torch.from_numpy(rng.random((SLICE_CLOUDS, SLICE_DRAWS, 3, 3), np.float32))
    pts = torch.from_numpy(clouds).to(device)
    t0 = time.perf_counter()
    got = slice_point_cloud_device(pts, target_partition_points=N_EXISTING,
                                   draws=draws.to(device))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    card_run = dict(slice_point_cloud_device.last_run)
    t0 = time.perf_counter()
    want = slice_point_cloud_device(torch.from_numpy(clouds), target_partition_points=N_EXISTING,
                                    draws=draws)
    cpu_s = time.perf_counter() - t0
    check(slice_point_cloud_device.last_run == card_run,
          f"phase 28: the card tested {card_run}, the CPU {slice_point_cloud_device.last_run}")
    check(torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1]),
          "phase 28: the card's slice differs from the CPU run on the same draws")
    both = torch.cat(got, dim=1).cpu().numpy()
    check(got[0].shape == (SLICE_CLOUDS, N_EXISTING, 3)
          and all(_same_rows(a, b) for a, b in zip(both, clouds)),
          "phase 28: a slice is not a partition of its cloud")

    def generated(rows, seed: int):
        gen = torch.Generator(device=device).manual_seed(seed)
        out = slice_point_cloud_device(pts[rows], gen, N_EXISTING)
        return out, dict(slice_point_cloud_device.last_run)

    every = slice(None)
    (existing, missing), _ = generated(every, 0)  # warm-up
    torch.cuda.synchronize()
    both = torch.cat([existing, missing], dim=1).cpu().numpy()
    check(all(_same_rows(a, b) for a, b in zip(both, clouds)),
          "phase 28: a generated slice is not a partition of its cloud")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, synced = generated(every, 1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the host syncs by line; the sync debug mode's own switch back warns
    # once, from torch.cuda
    where = collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                                if "synchroniz" in str(w.message))
    syncs = sum(n for line, n in where.items() if line.startswith("slicer.py:"))
    check(syncs == synced["blocks"], f"phase 28: {syncs} host syncs in the slicer in "
          f"{synced['blocks']} blocks ({dict(where)})")

    def timed(batch: int, calls) -> dict:
        """Clouds/s over ``calls`` of (rows, seed), ``batch`` clouds each."""
        t0 = time.perf_counter()
        runs = [generated(rows, seed)[1] for rows, seed in calls]
        torch.cuda.synchronize()
        clouds_run = batch * len(runs)
        blocks = [r["blocks"] for r in runs]
        return {"clouds_per_s": clouds_run / (time.perf_counter() - t0),
                "draws_tested_per_cloud": sum(r["draws_tested"] for r in runs) / clouds_run,
                "blocks_per_call": [min(blocks), statistics.mean(blocks), max(blocks)]}

    b64 = timed(SLICE_CLOUDS, [(every, seed) for seed in range(2, 7)])
    b1 = timed(1, [(i, 100 + i) for i in range(SLICE_CLOUDS)])
    host_rng = np.random.default_rng(SEED + 29)
    t0 = time.perf_counter()
    for cloud in clouds[:SLICE_HOST_CLOUDS]:
        first, second = slice_point_cloud(cloud, N_EXISTING, rng=host_rng)
        check(len(first) == N_EXISTING and len(first) + len(second) == N_OUT,
              "phase 28: the host slicer's sides")
    host = {"clouds": SLICE_HOST_CLOUDS,
            "clouds_per_s": SLICE_HOST_CLOUDS / (time.perf_counter() - t0)}
    return {"injected": {"card_s": card_s, "cpu_s": cpu_s,
                         "draws_tested_per_cloud": card_run["draws_tested"] / SLICE_CLOUDS,
                         "blocks": card_run["blocks"]},
            "syncs": {"host_syncs": syncs, "by_line": dict(where), "blocks": synced["blocks"],
                      "draws_tested_per_cloud": synced["draws_tested"] / SLICE_CLOUDS},
            "device_B64": b64, "device_B1": b1, "host": host}


# ---------------------------------------------------------------------------
# Phase 29: the bf16 training decode through K10 and its backward
# (``ops/decoder.py::decode_batch_train``) against the bmm chain.

DECODE_GRAD_REL_L2 = 1e-3  # bf16: both round each fp32 sum once, in another order (as the card tests)
DECODE_GRAD_CASES = (  # (channels, use_bias, batch, points): small, ragged, no bias, wide
    ((8, 16), True, 3, 64), ((16,), False, 2, 77), ((), True, 5, 300),
    ((32, 64, 128, 64), False, 3, 1000), ((32, 64, 128, 64), True, 1, 2048),
    ((128,), True, 2, 130), ((40, 24, 72), True, 3, 500), ((120, 24), False, 2, 700))


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


def decode_grad_vs_chain(model, device) -> dict:
    """Phase 29: ``decode_batch_grad`` (``csrc/decode_batch_grad.cu``) on the
    model's own flat weights (the hypernetwork's bf16 output for a B=64
    request) and ball points, N=2048, against its plain version and the
    chain's autograd (relative L2 <= DECODE_GRAD_REL_L2), bit-equal on two
    runs; ``decode_batch_train``'s value and gradient against the chain's;
    small, ragged, no-bias and wide widths (a hidden layer of 120 and of 128
    channels) against the plain version. Then the training decode's
    forward and backward both ways in turns (A B B A, twice; device ms with
    the calls queued behind a sleep), beside the least time of the work
    (forward, dW and dZ on the bf16 tensor cores) and each launch's ms."""
    from hyperpocket_tpu_torch.models.hyper_network import target_weight_count
    from hyperpocket_tpu_torch.models.target_network import batched_target_network_forward
    from hyperpocket_tpu_torch.ops import decoder
    from hyperpocket_tpu_torch.ops.sampling import generate_target_network_input_batch

    channels, use_bias = tuple(model.target_layer_out_channels), model.target_use_bias
    gen = torch.Generator(device=device).manual_seed(SEED + 29)
    net = model.serving_params().to(device)
    existing = torch.randn((SERVE_BATCH, N_EXISTING, 3), generator=gen, device=device) * 0.3
    noise = torch.randn((SERVE_BATCH, net.get_noise_size()), generator=gen, device=device) * 0.13
    with torch.no_grad():
        latent, _, _ = net._get_latent(existing.bfloat16(), None, None, False, noise.bfloat16(),
                                       None)
        flat = net.hyper_network(latent)
    del net
    balls = generate_target_network_input_batch(
        model.target_network_input, gen, 1e9, SERVE_BATCH, N_OUT).bfloat16()
    # a Chamfer gradient's scale: 1/N a point
    g_out = (torch.randn(balls.shape, generator=gen, device=device) / N_OUT).bfloat16()
    res = {"route": decoder.decode_grad_route(flat.requires_grad_(), balls, channels, use_bias)}
    check(res["route"] == "k10", f"phase 29: the chair decode routes to {res['route']}")
    flat = flat.detach()

    decoder.decode_batch_grad.launches = 0
    got = decoder.decode_batch_grad(flat, balls, g_out, channels, use_bias)
    again = decoder.decode_batch_grad(flat, balls, g_out, channels, use_bias)
    plain = decoder.decode_batch_grad_reference(flat, balls, g_out, channels, use_bias)
    f = flat.clone().requires_grad_()
    batched_target_network_forward(f, balls, list(channels), use_bias).backward(g_out)
    torch.cuda.synchronize()
    res.update(launches=decoder.decode_batch_grad.launches, bit_equal=torch.equal(got, again),
               rel_l2_plain=_rel_l2(got, plain), rel_l2_chain=_rel_l2(got, f.grad),
               plain_rel_l2_chain=_rel_l2(plain, f.grad),
               max_abs_err=(got.float() - plain.float()).abs().max().item(),
               finite=bool(torch.isfinite(got).all()))
    ft = flat.clone().requires_grad_()
    out = decoder.decode_batch_train(ft, balls, channels, use_bias)
    out.backward(g_out)
    f = flat.clone().requires_grad_()
    chain_out = batched_target_network_forward(f, balls, list(channels), use_bias)
    chain_out.backward(g_out)
    res.update(train_value_rel_l2=_rel_l2(out, chain_out),
               train_grad_rel_l2=_rel_l2(ft.grad, f.grad))
    print(f"phase 29: decode_batch_grad at B={SERVE_BATCH}, N={N_OUT}: {json.dumps(res)} "
          f"(limit {DECODE_GRAD_REL_L2})")
    check(res["launches"] == 2 and res["bit_equal"] and res["finite"],
          f"phase 29: launches {res['launches']}, bit-equal {res['bit_equal']}")
    check(max(res["rel_l2_plain"], res["rel_l2_chain"], res["train_value_rel_l2"],
              res["train_grad_rel_l2"]) <= DECODE_GRAD_REL_L2,
          f"phase 29: the backward is off the plain version or the chain: {res}")

    res["cases"] = {}
    for chans, bias, batch, n in DECODE_GRAD_CASES:
        w = target_weight_count(list(chans), bias)
        fl = (torch.randn((batch, w), generator=gen, device=device) * 0.3).bfloat16()
        pts = (torch.randn((batch, n, 3), generator=gen, device=device) * 0.5).bfloat16()
        go = (torch.randn((batch, n, 3), generator=gen, device=device) / n).bfloat16()
        got = decoder.decode_batch_grad(fl, pts, go, chans, bias)
        want = decoder.decode_batch_grad_reference(fl, pts, go, chans, bias)
        name = f"{'x'.join(map(str, chans)) or 'none'}_bias{int(bias)}_B{batch}_N{n}"
        res["cases"][name] = {"rel_l2": _rel_l2(got, want),
                              "route": decoder.decode_grad_route(fl.requires_grad_(), pts,
                                                                 chans, bias)}
        check(res["cases"][name]["rel_l2"] <= DECODE_GRAD_REL_L2
              and bool(torch.isfinite(got).all()), f"phase 29: {name}: {res['cases'][name]}")
    print(f"phase 29 cases: {json.dumps(res['cases'])}")

    flat_g = flat.clone().requires_grad_()

    def train_decode():
        out = decoder.decode_batch_train(flat_g, balls, channels, use_bias)
        torch.autograd.grad(out, flat_g, g_out)

    def chain_decode():
        out = batched_target_network_forward(flat_g, balls, list(channels), use_bias)
        torch.autograd.grad(out, flat_g, g_out)

    turns = {"chain": [], "k10": []}
    for _ in range(2):
        for which in AB_ORDER:
            name, fn = ("chain", chain_decode) if which == "a" else ("k10", train_decode)
            turns[name].append(device_ms(fn, iters=10))
    macs = sum(i * o for i, o in zip((3, *channels), (*channels, 3)))
    # forward, dW and dZ (the first layer's has no input gradient) a point
    work = 2 * SERVE_BATCH * N_OUT * (3 * macs - 3 * channels[0])
    res["times"] = {
        "turns_device_ms": turns, "ms": statistics.median(turns["k10"]),
        "chain_ms": statistics.median(turns["chain"]),
        "forward_ms": device_ms(lambda: decoder.decode_batch(flat, balls, channels, use_bias,
                                                             round_product=True)),
        "backward_ms": device_ms(lambda: decoder.decode_batch_grad(flat, balls, g_out, channels,
                                                                   use_bias)),
        "plain_ms": cuda_ms(lambda: decoder.decode_batch_grad_reference(
            flat, balls, g_out, channels, use_bias), iters=3),
        **bound(2 * (2 * flat.numel() + 2 * balls.numel()), work / BF16_FLOPS)}
    res["times"]["ratio_to_chain"] = res["times"]["ms"] / res["times"]["chain_ms"]
    res["times"]["bound_share"] = res["times"]["bound_ms"] / res["times"]["ms"]
    print(f"phase 29 timing: {json.dumps(res['times'])}")
    return res


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
        # the bf16 artifact of phase 19 at the same batch: the same kernels
        # through the exported program
        f = serving.load_completion(serving.export_completion(
            model, batch=batch, n_existing=N_EXISTING, num_output_points=N_OUT, device=device))
        wall_ms = 1e3 * batch / clouds_per_s(lambda s: f(existing, noise, s), batch,
                                             iters=20, windows=1)["clouds_per_s"]
        record(f"artifact_bf16_B{batch}", lambda s: f(existing, noise, s), wall_ms, calls)
        del f

    tr = config["training"]
    # bf16 with the cuBLAS trunk, with K8 (the card's route) and with K11 (the fused
    # head step)
    for name, dtype, fused_fwd, fused_head in (
            ("fp32", "float32", False, False), ("bf16", "bfloat16", False, False),
            ("bf16_fused_fwd", "bfloat16", True, False),
            ("bf16_fused_head", "bfloat16", False, True)):
        m = copy.deepcopy(model32)
        m.compute_dtype = dtype
        m = m.to(device)
        w = m.hyper_network.heads.weight
        params = [p for p in optim.trainable_parameters(m) if not (fused_head and p is w)]
        opt = optim.make_optimizer(tr["optimizer"], params)
        if fused_head:
            head = trainer.init_head_adam_state(m, "float32")
            inner = trainer.make_fused_train_step(m, opt, float(tr["loss_coef"]))
            step = lambda *a: inner(head, *a)  # noqa: E731
        else:
            step = trainer.make_train_step(m, opt, float(tr["loss_coef"]))
        batch = train_batch(m, TRAIN_BATCH, SEED + 6, device)

        def run(s):
            return step(batch["existing"], batch["missing"], batch["gt"], gen, 1.0, N_OUT)

        with trunk_route("k8" if fused_fwd else "sparse"):
            wall_ms = step_ms(run, iters=10, windows=1)["ms"]
            record(f"train_step_{name}_B{TRAIN_BATCH}", run, wall_ms, 3)
        del m, opt, step
        torch.cuda.empty_cache()
    # one 512-pair CD + EMD dispatch of evaluate_generativity at N=M=1024
    from hyperpocket_tpu_torch.eval.metrics import _pair_ops

    rows = torch.randn((EVAL_OBJECTS, N_EXISTING, 3), generator=gen, device=device) * 0.3
    cols = torch.randn((EVAL_OBJECTS ** 2, N_EXISTING, 3), generator=gen, device=device) * 0.3
    pair = torch.arange(512, device=device)

    def dispatch(s):
        return _pair_ops(rows, cols, pair % EVAL_OBJECTS, pair // EVAL_OBJECTS)

    wall_ms = step_ms(dispatch, iters=3, windows=1, warmup=1)["ms"]
    record("pair_ops_512_N1024", dispatch, wall_ms, 1)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=1))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=Path, default=None, metavar="PATH",
                    help="also write the per-kernel device time of serving calls, "
                         "train steps and one eval pair dispatch to PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke needs a GPU",
              file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}; SM clock, power, temperature at the start: {clock_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    from hyperpocket_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib._name}")
    log = Path(lib._name).parent / _build.LOG_NAME
    ptxas_check(log, "trunk_pool_kernel", "trunk")
    ptxas_check(log, "nn_fused_kernel", "fused NN sweep")
    ptxas_check(log, "decode_batch_tc_kernel", "bf16 decode")
    ptxas_check(log, "decode_batch_kernel", "CUDA-core decode")
    ptxas_check(log, "decode_batch_grad", "decode backward")

    from hyperpocket_tpu_torch.data import plyio

    # the JAX package's dispatch: the native library where it loads, else numpy
    print(f"PLY reader: {plyio.reader()}")
    config, model = build_model("bfloat16")
    model32 = copy.deepcopy(model)
    model32.compute_dtype = "float32"

    served = model.serving_params().to(device)
    kern = kernel_vs_plain(served, device)
    argmax = trunk_argmax_vs_plain(served, device)
    del served
    head = head_adam_vs_plain(device)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        sl = drive_slice(config, model, model32, device, Path(tmp))
    print(f"slice: {json.dumps(sl)}")
    tp = throughput(model, model32, device)
    print(f"throughput: {json.dumps(tp)} on {card}")
    nn_kern = nn_kernels_vs_plain(device)
    cham = chamfer_vs_plain(device)
    print(f"chamfer: {json.dumps(cham)}")
    training = drive_training(config, model32, device)
    print(f"training: {json.dumps(training)} on {card}")
    emd_kern = emd_kernels_vs_plain(device)
    descent = emd_descent(device)
    with tempfile.TemporaryDirectory() as tmp:
        experiments = drive_experiments(model32, device, Path(tmp))
    print(f"experiments: {json.dumps(experiments)} on {card}")
    with tempfile.TemporaryDirectory() as tmp:
        cli_training = drive_cli_training(device, Path(tmp))
    print(f"cli training: {json.dumps(cli_training)} on {card}")
    fused = fused_train_step(config, model32, device)
    torch.cuda.empty_cache()
    k5 = nn_fused_vs_plain(model32, device)
    print(f"K5: {json.dumps(k5)} on {card}")
    torch.cuda.empty_cache()
    k9 = chamfer_fused_vs_plain(device)
    print(f"K9: {json.dumps(k9)} on {card}")
    torch.cuda.empty_cache()
    k10 = decode_vs_plain(model, model32, device)
    print(f"K10: {json.dumps(k10)} on {card}")
    torch.cuda.empty_cache()
    walls = {}
    for name, phase in (("export", lambda tmp: drive_export(model, model32, device, tmp)),
                        ("serving_cli", lambda tmp: drive_serving_cli(model, device, tmp)),
                        ("hyperrec", lambda tmp: drive_hyperrec(device, tmp))):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            res = phase(Path(tmp))
        walls[name] = time.perf_counter() - t0
        print(f"{name}: {json.dumps(res)} on {card}")
        torch.cuda.empty_cache()
    print(f"phases 19-21 wall s: {json.dumps(walls)}")
    walls = {}
    parallel = {}
    for name, phase in (("dp_trainer", lambda tmp: drive_dp_trainer(device, tmp)),
                        ("ring", lambda tmp: drive_ring(device, tmp)),
                        ("sharded_pairs", lambda tmp: drive_sharded_pairs(device, tmp)),
                        ("dp_serving", lambda tmp: drive_dp_serving(model, device, tmp))):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            parallel[name] = phase(Path(tmp))
        walls[name] = time.perf_counter() - t0
        print(f"{name}: {json.dumps(parallel[name])} on {card}")
        torch.cuda.empty_cache()
    print(f"phases 22-25 wall s: {json.dumps(walls)}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        scan = drive_scan_epochs(device, Path(tmp))
    print(f"scan epochs: {json.dumps(scan)} on {card}")
    print(f"phase 26 wall s: {time.perf_counter() - t0!r}")
    t0 = time.perf_counter()
    adam = adam_lowp_vs_plain(model32, device)
    k9_graph = k9_replays_as_eager(device)
    with tempfile.TemporaryDirectory() as tmp:
        routes = drive_train_routes(device, Path(tmp))
    print(f"train routes: {json.dumps({'k9_graph': k9_graph, **routes})} on {card}")
    print(f"phase 27 wall s: {time.perf_counter() - t0!r}")
    t0 = time.perf_counter()
    sliced = drive_slicer(device)
    print(f"slicer: {json.dumps(sliced)} on {card}")
    print(f"phase 28 wall s: {time.perf_counter() - t0!r}")
    t0 = time.perf_counter()
    dgrad = decode_grad_vs_chain(model, device)
    print(f"phase 29 wall s: {time.perf_counter() - t0!r}")
    if args.profile is not None:
        profile(config, model, model32, device, args.profile)
        print(f"profile: written to {args.profile}")

    # each kernel's launches in phase 26's scanned runs (fp32, bf16, bf16 + K8),
    # replays included
    scan_launches = collections.Counter()
    for case in scan.values():
        scan_launches.update(case["launches"])

    def entry(name, source, replaces, launches, max_abs_err, t, ms_key="ms",
              library_key="library_ms", scan_key=None, scan_case=None):
        return {"name": name, "route": "cuda", "source": f"hyperpocket_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": max_abs_err,
                "ms": t[ms_key], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t[library_key],
                "scan_launches": (scan[scan_case]["launches"].get(scan_key, 0) if scan_case
                                  else scan_launches[scan_key] if scan_key else 0)}

    fp32 = training["float32"]
    fast = cli_training["config_3depn_chair_fast.json"]["runs"][0]["launches"]
    eval_launches = experiments["config_missing_shapenet.json"]["launches"]
    kernels = [
        entry("trunk_pool", "trunk_pool.cu", "hyperpocket_tpu/ops/pallas_encoder.py:198",
              sl["launches"], kern["max_abs_err"], kern["times"]["B256_N1024"],
              ms_key="kernel_ms", library_key="bf16_matmul_chain_ms", scan_key="trunk_pooled"),
        # K1: the train steps under deterministic algorithms (phase 22's one-process
        # Trainer; by default the card trains through K9)
        *(entry(name, f"{name}.cu", f"hyperpocket_tpu/ops/pallas_nn.py:{line}", launches,
                nn_kern["errs"][name], nn_kern["times"][name], scan_key=name)
          for name, line, launches in (
              ("nn_one_direction", 125,
               parallel["dp_trainer"]["one_process"]["train_launches"]["nn_one_direction"]),
              ("nn_min_fused", 223, fp32["val_launches"]["nn_min_fused"]))),
        *(entry(name, f"{name}.cu", f"hyperpocket_tpu/ops/pallas_emd.py:{line}", launches,
                emd_kern["errs"][name], emd_kern["times"]["B512_1024"][name])
          for name, line, launches in (
              ("emd_match_cost", 273, eval_launches["emd_match_cost"]),
              ("emd_match_cost_grad", 414, descent["launches"]["emd_match_cost_grad"]))),
        entry("trunk_pool_argmax", "trunk_pool.cu", "hyperpocket_tpu/ops/pallas_encoder.py:279",
              fast["trunk_pool_argmax"], argmax["max_abs_err"], argmax["times"]["B64_N1024"],
              scan_key="trunk_pooled_argmax"),
        entry("head_adam", "head_adam.cu", "hyperpocket_tpu/ops/pallas_head_adam.py:88",
              fused["fused"]["launches"], head["max_abs_err"], head["times"]),
        entry("nn_fused_planes", "nn_fused_planes.cu", "hyperpocket_tpu/ops/pallas_nn.py:386",
              k5["launches"]["nn_fused_planes"], k5["max_abs_err"], k5["times"]["B64_1024x2048"]),
        entry("chamfer_loss_grad", "chamfer_loss_grad.cu", "hyperpocket_tpu/ops/pallas_nn.py:580",
              fp32["train_launches"]["chamfer_loss_grad"], k9["max_abs_err"],
              k9["times"]["B64_2048x2048"], scan_key="chamfer_loss_grad"),
        # K10: bf16 (tensor cores) on the bf16 serving path, fp32 (CUDA cores) on the fp32
        # val step's
        entry("decode_batch", "decode_batch_tc.cu", "hyperpocket_tpu/ops/pallas_decoder.py:117",
              sl["decode_launches"], k10["cases"][f"bf16_B{BENCH_BATCH}"]["max_abs_err"],
              k10["times"][f"bf16_B{BENCH_BATCH}"], library_key="chain_ms",
              scan_key="decode_batch", scan_case="bf16"),
        entry("decode_batch_fp32", "decode_batch.cu", "hyperpocket_tpu/ops/pallas_decoder.py:117",
              fp32["val_launches"]["decode_batch"],
              k10["cases"][f"fp32_B{BENCH_BATCH}"]["max_abs_err"],
              k10["times"][f"fp32_B{BENCH_BATCH}"], library_key="chain_ms",
              scan_key="decode_batch", scan_case="fp32"),
        # the same source's bf16 instantiation, for bf16 widths the tensor cores' kernel
        # cannot hold: a 272-channel model's inference forward (phase 18)
        entry("decode_batch_bf16_simt", "decode_batch.cu",
              "hyperpocket_tpu/ops/pallas_decoder.py:117",
              k10["wide_model_launches"]["decode_batch_bf16_simt"], k10["small_err"]["bf16_wide"],
              k10["times"][f"bf16_simt_272_B{SERVE_BATCH}"], library_key="chain_ms"),
        # not a TPU kernel: the bf16 training decode's backward (the JAX package trains
        # through XLA's bmm chain); launches in phase 8's bf16 train steps. Its time is
        # K10's forward and the backward together, against the chain's autograd
        entry("decode_batch_grad", "decode_batch_grad.cu",
              "hyperpocket_tpu/models/target_network.py (XLA)",
              training["bfloat16"]["train_launches"]["decode_batch_grad"], dgrad["max_abs_err"],
              dgrad["times"], library_key="chain_ms", scan_key="decode_batch_grad"),
        # not a TPU kernel: scale_by_adam_lowp is XLA inside the jitted JAX step;
        # launches in the fast config's training-CLI run (phase 14)
        entry("adam_lowp", "adam_lowp.cu", "hyperpocket_tpu/train/optim.py:29", fast["adam_lowp"],
              adam["max_abs_err"], adam["times"], scan_key="adam_lowp_update"),
    ]
    print(f"SM clock, power, temperature at the end: {clock_line()}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
