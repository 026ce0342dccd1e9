"""Serving traffic: one client in a closed loop over ``make_serving_fn``.

Each call hands the serving callable host arrays (a batch of partial scans
and its latent noise) and a seed for the ball draw, and ends when the
completions are in the client's host array: one, reused from call to call,
as a loop that writes each batch out before it asks for the next. (``infer``
makes a fresh array a call instead; PERF.md keeps what that costs.) The
next call starts when the last has ended. The calls cycle through
``pool_batches`` distinct batches made on the card from the seed; every
call has its own ball seed.

Parameters (the workload file's ``params``): ``batch``, ``n_existing``,
``n_gt`` (points of the shape a partial scan is cut from), ``n_out``,
``noise_std``, ``compute_dtype``, ``pool_batches``, ``sample_calls`` (the
calls compared with the reference, a sample drawn from the seed of those
finished), ``trace_calls`` (the traced window ends after that many calls
at the latest) and ``limits``.

``correct``: the sampled completions against the plain reference's (fp32,
TF32 off, from the same weights, scans, noise and ball seed):
``rel_gap = |out - ref| / |ref|`` over every point of the sample.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.counts import model as counts
from benchmark.harness import Check, Outcome
from benchmark.reference import model as ref
from benchmark.trace import WINDOW, profiled, spanned

UNITS = {"setup_s": "s", "serve_clouds_per_s": "clouds/s"}
EPOCH = 1e9  # make_serving_fn's default: past the progressive schedule
REF_BLOCK = 64  # clouds a block of the reference's forward, which bounds its memory


def model_section(run) -> dict:
    """The configuration's ``full_model`` in the cell's compute dtype."""
    return dict(run.config["settings"]["full_model"], compute_dtype=run.params["compute_dtype"])


def build(run):
    """(serving fn, fp32 weights, model section) from the run's seed."""
    from hyperpocket_tpu_torch.models.full_model import FullModel
    from hyperpocket_tpu_torch.serving import make_serving_fn
    from hyperpocket_tpu_torch.train.trainer import set_matmul_precision

    run.mark("import program")
    p = run.params
    set_matmul_precision(run.config["settings"]["training"].get("matmul_precision", "highest"))
    model_cfg = model_section(run)
    weights = inputs.make_weights(model_cfg, run.sub_seed("weights"), run.device)
    run.mark("weights on the card")
    with torch.device("meta"):
        model = FullModel.from_config(model_cfg)
    model = model.to_empty(device=run.device)
    model.load_state_dict(weights, strict=True)
    fn = make_serving_fn(model, num_output_points=p["n_out"], epoch=EPOCH, device=run.device)
    run.mark("model, serving fn")
    return fn, weights, model_cfg


def make_pool(run, model_cfg):
    """``pool_batches`` batches of partial scans and noise on the device, and
    their host copies the client sends."""
    p = run.params
    g = torch.Generator(device=run.device).manual_seed(run.sub_seed("scans"))
    count = p["pool_batches"] * p["batch"]
    _, existing, _ = inputs.make_scans(g, count, p["n_gt"], p["n_existing"])
    zdim = int(model_cfg["random_encoder"]["output_size"])
    noise = torch.randn((count, max(zdim, 0)), generator=g, device=run.device) * p["noise_std"]
    existing = existing.view(p["pool_batches"], p["batch"], p["n_existing"], 3)
    noise = noise.view(p["pool_batches"], p["batch"], -1)
    host = [(existing[k].cpu().numpy(), noise[k].cpu().numpy()) for k in range(p["pool_batches"])]
    return existing, noise, host


def run(run) -> Outcome:
    p = run.params
    fn, weights, model_cfg = build(run)
    existing, noise, host = make_pool(run, model_cfg)
    run.mark("scans")
    ball_seed = run.sub_seed("balls")
    rng = np.random.default_rng(run.sub_seed("sample"))

    # the client's host array for a call's completions, reused call after
    # call and touched once here: a fresh array a call would time the host
    # allocator's page faults, which change with the process's history
    completions = torch.zeros((p["batch"], p["n_out"], 3), dtype=torch.float32)
    serve, to_host = fn, completions.copy_
    if run.trace:  # spans around the serving call and the completion's way back
        serve, to_host = spanned("serve.call", fn), spanned("serve.to_host", completions.copy_)

    def call(i):
        ex, nz = host[i % len(host)]
        to_host(serve(ex, nz, ball_seed + i))
        return completions.numpy()

    for i in range(3):  # the capture of the one signature, then two replays
        call(i)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.mark("3 calls (the capture)")
    setup_s = time.perf_counter() - run.t0

    # a uniform sample of the calls finished, copied out of the client's array
    kept = np.zeros((p["sample_calls"], p["batch"], p["n_out"], 3), np.float32)
    sample: list = []  # call index of each slot of ``kept``
    limit_calls = p["trace_calls"] if run.trace else None
    i = 0
    with profiled(run.trace) as traced:
        with torch.profiler.record_function(WINDOW):
            start, cpu = time.perf_counter(), time.process_time()
            deadline = start + run.seconds
            fifths = []  # (seconds, calls) as each fifth of the window passes
            while True:
                out = call(i)
                if len(sample) < p["sample_calls"]:
                    kept[len(sample)] = out
                    sample.append(i)
                else:
                    j = int(rng.integers(0, i + 1))
                    if j < p["sample_calls"]:
                        kept[j] = out
                        sample[j] = i
                i += 1
                now = time.perf_counter()
                if now >= start + run.seconds * (len(fifths) + 1) / 5:
                    fifths.append((now - start, i))
                if now >= deadline or (limit_calls is not None and i >= limit_calls):
                    break
    window_s, cpu_s = now - start, time.process_time() - cpu
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    del fn
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()

    gap = compare(run, weights, model_cfg, existing, noise, ball_seed, zip(sample, kept))
    clouds = i * p["batch"]
    flops = counts.serve_flops_a_cloud(model_cfg, p["n_existing"], p["n_out"])
    return Outcome(
        attempted=i, failed=0,
        metrics={"setup_s": setup_s, "serve_clouds_per_s": clouds / window_s},
        checks=[Check("rel_gap", gap, p["limits"]["rel_gap"])],
        memory_peak_bytes=peak,
        counters={"kind": "serve", "calls": i, "clouds": clouds, "batch": p["batch"],
                  "n_existing": p["n_existing"], "n_out": p["n_out"],
                  "dtype": p["compute_dtype"], "model": model_cfg, "flops": clouds * flops,
                  "window_s": window_s, "notes": notes(window_s, cpu_s, fifths, p["batch"])},
        trace=traced.summary)


def notes(window_s: float, cpu_s: float, fifths: list, batch: int) -> list[str]:
    """What shows where a run's rate came from (printed on stderr): the rate
    in each fifth of the window and the process's CPU seconds (every
    thread's) a second of the window."""
    rates, last = [], (0.0, 0)
    for t, n in fifths:
        rates.append(f"{(n - last[1]) * batch / (t - last[0]):.1f}")
        last = (t, n)
    return [f"window clouds/s by fifths: {' '.join(rates)}",
            f"window cpu s per s: {cpu_s / window_s:.4f}"]


def reference_completions(weights, model_cfg, existing, noise, seed, n_out, q=None):
    """The reference's completions of one call: its ball points drawn from
    ``seed`` for the whole batch, the forward in blocks of ``REF_BLOCK`` clouds."""
    g = torch.Generator(device=existing.device).manual_seed(seed)
    balls = ref.ball_points(g, existing.shape[0], n_out, EPOCH,
                            model_cfg["target_network_input"])
    outs = []
    with torch.no_grad(), ref.fp32_highest():
        for s in range(0, existing.shape[0], REF_BLOCK):
            block = slice(s, s + REF_BLOCK)
            outs.append(ref.complete(weights, model_cfg, existing[block], noise[block],
                                     balls[block], q))
    return torch.cat(outs)


def compare(run, weights, model_cfg, existing, noise, ball_seed, sample, q=None) -> float:
    """The sampled completions' distance to the reference's, over the norm
    of the reference's: ``|out - ref| / |ref|`` over every point of the sample."""
    p = run.params
    diff = norm = 0.0
    for i, out in sample:
        k = i % existing.shape[0]
        want = reference_completions(weights, model_cfg, existing[k], noise[k], ball_seed + i,
                                     p["n_out"], q)
        got = torch.as_tensor(out, device=want.device, dtype=torch.float32)
        diff += float((got - want).square().sum())
        norm += float(want.square().sum())
    return (diff / max(norm, 1e-30)) ** 0.5


def control(run, q) -> float:
    """``rel_gap`` with the reference rounded by ``q`` in the program's place,
    on the first ``sample_calls`` calls of the run's inputs (no program runs)."""
    p = run.params
    model_cfg = model_section(run)
    weights = inputs.make_weights(model_cfg, run.sub_seed("weights"), run.device)
    existing, noise, _ = make_pool(run, model_cfg)
    ball_seed = run.sub_seed("balls")
    sample = []
    for i in range(p["sample_calls"]):
        k = i % existing.shape[0]
        sample.append((i, reference_completions(weights, model_cfg, existing[k], noise[k],
                                                ball_seed + i, p["n_out"], q)))
    return compare(run, weights, model_cfg, existing, noise, ball_seed, sample)
