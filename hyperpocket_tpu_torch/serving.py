"""Completion serving: existing half-cloud + latent noise -> completed cloud.

Port of ``hyperpocket_tpu/serving.py``. Serving signature::

    f(existing (B, N, 3) f32, noise (B, Z) f32, seed int) -> (B, num_output_points, 3) f32

``make_serving_fn`` returns it with the (serving-cast) parameters closed
over. ``export_completion`` writes the completion forward as a
``torch.export`` artifact (``.pt2`` bytes) that serves without the config or
the checkpoint tree, and ``load_completion`` gives the same callable back
from those bytes. The seed seeds a ``torch.Generator`` on the serving device
that draws the target network's ball points: a fixed seed gives a fixed
completion, the same through the artifact as through ``make_serving_fn``,
but not the JAX package's bits for the same seed.

The artifact's program takes ``(existing, noise, ball_points)``: a generator
cannot be an input of an exported program, so ``load_completion`` draws the
ball points from the seed with the sampling settings stored inside the
``.pt2`` (``target_network_input``, ``ball_method``, the epoch and the point
count). The parameters are cast once to the compute dtype and travel inside
the artifact; batch and ``n_existing`` are fixed. The fused trunk kernel K4
is the custom op ``hyperpocket::trunk_pooled`` in the exported graph, so
loading an artifact needs this package (for the op), not the model code's
config or checkpoints. The exporting device is the serving device: the
route through K4 and every tensor's device are fixed at export, and an
artifact exported on ``cuda`` refuses to load where CUDA is absent.

On a CUDA device each serving callable, from ``make_serving_fn`` or
``load_completion``, captures its forward once for each input signature
(batch, ``n_existing``, ``num_output_points``, compute dtype, device) into
a CUDA graph and replays it at every later call
(``utils/cuda_graph.py::GraphCache``), as ``jax.jit`` compiles once per
shape; the artifact's program has one signature. The ball draw is
captured with the forward, from a generator of the callable's own that each
call seeds with its seed (the draw ``FullModel.apply`` makes when noise is
given, so the bits are the eager forward's); a call copies its inputs into
the graph's static buffers, replays once and returns a clone of the output. The
first call of a signature also runs the forward once eagerly to warm up,
so the wrappers' launch counts read two launches of each kernel there and
one at every later call. A capture that fails raises ``GraphCaptureError``
naming the line; nothing serves eagerly on a card. The serving net owns
its weights (a snapshot, in fp32 too), so that the caller may update or
free its model after ``make_serving_fn``. On the CPU the forward runs
eagerly.

Data-parallel serving runs one process per card (``parallel/``): every
rank takes the global batch, draws the global ball points from the seed,
serves its rows and all-gathers the output, so the result is the
one-process output for the same seed. ``make_serving_fn(mesh=)`` does it
from the weights; ``export_completion(data_parallel=N)`` exports the
per-rank program at ``batch / N`` and records ``data_parallel``, and
``load_completion`` of such an artifact must run in a world of N ranks.

CLI::

    # export (bare flags are export too)
    python -m hyperpocket_tpu_torch.serving export --config settings/config_3depn_chair.json \\
        --out model.pt2 [--batch 64] [--n-existing 1024] [--points 2048] [--epoch best_val] \\
        [--device cuda] [--data-parallel N]

    # PLY in, completion PLY out, from an artifact or from a config's checkpoint
    python -m hyperpocket_tpu_torch.serving infer (--artifact model.pt2 | --config cfg.json) \\
        --inputs scan1.ply scan2.ply --out-dir completions/ \\
        [--samples 4 --noise-std 0.13 | --latent-prior prior.npz] [--seed 0] [--no-normalize]

    # fit the latent prior that infer --latent-prior draws from
    python -m hyperpocket_tpu_torch.serving fit-prior --config cfg.json --out prior.npz \\
        [--max-items 1024] [--batch-size 64] [--device cuda]

``export`` also writes ``<out>.json`` with the JAX package's keys
(``platform`` holds the torch device type). ``infer --config`` takes
``--epoch``, ``--batch``, ``--n-existing``, ``--points`` and ``--device``
itself and restores the JAX-layout checkpoint of the config's results tree
(``train/checkpoint.py``); with ``--artifact`` those come from the artifact.
Inputs are normalised into the 0.9 box like the real-scan dataset and
completions are mapped back by inverting that transform; the tail of the
jobs is padded to the fixed batch. ``--device`` defaults to ``cuda`` and
raises when CUDA is absent.
"""

from __future__ import annotations

import argparse
import copy
import io
import json
import os
import sys
import zipfile
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from hyperpocket_tpu_torch.data.base import resample_pcd
from hyperpocket_tpu_torch.data.plyio import load_ply, save_ply
from hyperpocket_tpu_torch.data.real_data import get_scales
from hyperpocket_tpu_torch.models.full_model import FullModel
from hyperpocket_tpu_torch.ops.sampling import generate_target_network_input_batch
from hyperpocket_tpu_torch.parallel import distributed
from hyperpocket_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, all_gather_cat, batch_rows
from hyperpocket_tpu_torch.train.checkpoint import restore_trained_model
from hyperpocket_tpu_torch.utils.cuda_graph import GraphCache

ARTIFACT_SUFFIX = ".pt2"
META_FILE = "hyperpocket_serving.json"  # the sampling settings inside the .pt2


def resolve_device(device: str | torch.device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def _serving_net(model: FullModel, params_or_module, device: torch.device) -> FullModel:
    """The weights cast once to the compute dtype on ``device``, in a module
    of their own: a captured graph reads them at fixed addresses, as
    ``jax.jit`` closes over the parameters it was given."""
    if isinstance(params_or_module, Mapping):
        net = copy.deepcopy(model)
        net.load_state_dict(params_or_module)
        return net.serving_params().to(device)
    source = model if params_or_module is None else params_or_module
    net = source.serving_params()
    return (copy.deepcopy(net) if net is source else net).to(device)


def _data_parallel(mesh: Mesh, serve, existing, noise, balls) -> torch.Tensor:
    """This rank's rows of the global batch through ``serve``, gathered."""
    rows = batch_rows(mesh, existing.shape[0])
    return all_gather_cat(serve(existing[rows], noise[rows], balls[rows]),
                          mesh.group(DATA_AXIS))


def _completion(forward, draw, device: torch.device, mesh: Mesh | None, name: str,
                static: tuple):
    """``f(existing, noise, seed)``: ``forward(existing, noise, balls)``
    without autograd, the ball points ``draw(generator, batch)`` from a
    generator seeded with ``seed`` (under ``mesh`` this rank's rows,
    gathered); on a card one CUDA graph per signature, the draw in it."""
    generator = torch.Generator(device=device)

    def run(existing, noise):
        with torch.no_grad():
            balls = draw(generator, existing.shape[0])
            if mesh is None:
                return forward(existing, noise, balls)
            return _data_parallel(mesh, forward, existing, noise, balls)

    graphs = GraphCache(run, device, name=name, static=static, generator=generator)

    def completion(existing, noise, seed: int) -> torch.Tensor:
        existing = torch.as_tensor(existing, dtype=torch.float32, device=device)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=device)
        return graphs(existing, noise, seed=seed)

    completion.graphs = graphs
    return completion


def make_serving_fn(model: FullModel, params_or_module: FullModel | Mapping | None = None, *,
                    num_output_points: int = 2048, epoch: float = 1e9,
                    device: str | torch.device = "cuda", mesh: Mesh | None = None):
    """``f(existing, noise, seed) -> completion`` with the parameters closed over.

    ``params_or_module``: a ``FullModel`` holding the weights, a state_dict
    to load into a copy of ``model``, or None for ``model``'s own weights.
    They are copied, cast once to the compute dtype (``serving_params``) and
    moved to ``device``. ``epoch`` feeds the progressive ball normalisation;
    past the schedule (the default) every ball point lies on the unit sphere.
    On a card each input signature is captured once and replayed
    (``f.graphs``, a ``GraphCache``).

    With ``mesh`` (``parallel.make_mesh``) every rank calls ``f`` with the
    global batch: it serves its rows of the data axis, with its rows of the
    ball points drawn for the global batch, and returns the gathered
    global output.
    """
    device = resolve_device(device)
    if mesh is not None:
        device = distributed.rank_device(device)
    net = _serving_net(model, params_or_module, device)
    epoch = float(epoch)
    return _completion(
        lambda e, n, b: net.apply(e, None, None, epoch, num_output_points=num_output_points,
                                  training=False, noise=n, ball_points=b),
        lambda generator, batch: generate_target_network_input_batch(
            net.target_network_input, generator, epoch, batch, num_output_points,
            method=net.ball_method),
        device, mesh, "the serving forward", (net.compute_dtype, num_output_points))


class _CompletionProgram(nn.Module):
    """The exported forward: ``(existing, noise, ball_points) -> completion``.

    ``FullModel._forward`` with the inference flags, traced under the
    exporter's ``torch.no_grad``; ``apply`` opens its own.
    """

    def __init__(self, net: FullModel, num_output_points: int):
        super().__init__()
        self.net = net
        self.num_output_points = num_output_points

    def forward(self, existing, noise, ball_points):
        return self.net._forward(existing, None, None, None, self.num_output_points, False,
                                 noise, None, ball_points, None, False)


def export_completion(model: FullModel, params_or_module: FullModel | Mapping | None = None, *,
                      batch: int, n_existing: int = 1024, num_output_points: int = 2048,
                      epoch: float = 1e9, data_parallel: int | None = None,
                      device: str | torch.device = "cuda") -> bytes:
    """The completion forward for (batch, n_existing) inputs as ``.pt2`` bytes.

    ``params_or_module`` as in ``make_serving_fn``. The program is traced on
    ``device``, which becomes the artifact's serving device.
    ``data_parallel=N`` exports the per-rank program, at ``batch / N`` rows
    (``batch % N`` raises), and records N: ``load_completion`` then serves
    the global batch over N ranks.
    """
    local = batch
    if data_parallel is not None:
        if data_parallel < 1 or batch % data_parallel:
            raise ValueError(f"batch {batch} not divisible by data_parallel {data_parallel}")
        local = batch // data_parallel
    device = resolve_device(device)
    net = _serving_net(model, params_or_module, device)
    example = (torch.zeros((local, n_existing, 3), device=device),
               torch.zeros((local, net.get_noise_size()), device=device),
               torch.zeros((local, num_output_points, 3), device=device))
    with torch.no_grad():
        program = torch.export.export(_CompletionProgram(net, num_output_points), example,
                                      strict=False)
    meta = {
        "device": str(device),
        "batch": batch,
        "n_existing": n_existing,
        "num_output_points": num_output_points,
        "noise_size": net.get_noise_size(),
        "epoch": float(epoch),
        "target_network_input": net.target_network_input,
        "ball_method": net.ball_method,
        "compute_dtype": net.compute_dtype,
        "data_parallel": data_parallel,
    }
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={META_FILE: json.dumps(meta)})
    return buf.getvalue()


def artifact_meta(data: bytes) -> dict:
    """The sampling settings stored in an artifact, read without loading its program."""
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        for name in zf.namelist():
            parts = name.split("/")
            if parts[-1] == META_FILE and parts[-2] in ("extra", "extra_files"):
                return json.loads(zf.read(name))
    raise ValueError(f"not a completion artifact: no {META_FILE} inside")


def load_completion(data: bytes):
    """The serving callable from artifact bytes; ``.meta`` holds its settings.

    Raises when the artifact's device is absent (an artifact exported on
    ``cuda`` never serves on the CPU). The ball points are drawn from the
    seed exactly as ``make_serving_fn`` draws them.

    An artifact exported with ``data_parallel=N`` needs a world of N ranks
    (one process and no group for N = 1). Under a process group every rank
    calls the callable with the global batch and gets the global output:
    it serves its rows and the ranks all-gather. On a card the program is
    captured once, at its one signature, and replayed (``f.graphs``).
    """
    meta = artifact_meta(data)
    dp = meta.get("data_parallel")
    world = distributed.world_size()
    if dp is not None and dp != world:
        raise ValueError(f"the artifact was exported with data_parallel={dp}; it serves in a "
                         f"world of {dp} ranks, this one has {world}")
    device = resolve_device(meta["device"])
    mesh = None
    if dp is not None and distributed.is_initialized():
        from hyperpocket_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(dp, 1)
        device = distributed.rank_device(device)
    program = torch.export.load(io.BytesIO(data)).module()
    if mesh is not None:
        program.to(device)  # the weights as exported sit on the exporting card
    completion = _completion(
        program, lambda generator, batch: generate_target_network_input_batch(
            meta["target_network_input"], generator, meta["epoch"], batch,
            meta["num_output_points"], method=meta["ball_method"]),
        device, mesh, "the artifact's program", (meta["compute_dtype"],))
    completion.meta = meta
    return completion


def _load_prior(path: str | None, zdim: int):
    """The latent prior of ``infer --latent-prior``, checked against the noise size."""
    if path is None:
        return None
    from hyperpocket_tpu_torch.eval.latent_stats import load_latent_gaussian

    lg = load_latent_gaussian(path)
    if lg.dim != zdim:
        raise SystemExit(f"latent prior dim {lg.dim} != noise_size {zdim}")
    return lg


def infer_main(argv=None) -> int:
    """``python -m hyperpocket_tpu_torch.serving infer``: PLY in -> completion PLY out."""
    ap = argparse.ArgumentParser(
        prog="python -m hyperpocket_tpu_torch.serving infer",
        description="Complete partial point clouds from PLY files with an exported "
                    "artifact or a trained model's checkpoint")
    source = ap.add_mutually_exclusive_group(required=True)
    source.add_argument("--artifact", help="artifact written by `export` (.pt2)")
    source.add_argument("-c", "--config",
                        help="training config json (reference schema) naming the results tree")
    ap.add_argument("--inputs", nargs="+", required=True, help="partial-cloud .ply files")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--epoch", default=None,
                    help="--config only: restore policy latest | best_val | <int> "
                         "(default: the config's experiments.epoch, else latest)")
    ap.add_argument("--batch", type=int, default=None, help="--config only (default 64)")
    ap.add_argument("--n-existing", type=int, default=None, help="--config only (default 1024)")
    ap.add_argument("--points", type=int, default=None, help="--config only (default 2048)")
    ap.add_argument("--device", default=None,
                    help="--config only (default cuda); an artifact serves on the device "
                         "it was exported on")
    ap.add_argument("--seed", type=int, default=0,
                    help="ball-sampling/noise seed (fixed seed + zero noise "
                         "=> deterministic completions)")
    ap.add_argument("--samples", type=int, default=1,
                    help="completions per input (fresh latent noise each)")
    ap.add_argument("--noise-std", type=float, default=0.0,
                    help="latent noise std (the reference's fixed experiment "
                         "uses 0.13; 0 = zero-noise completion)")
    ap.add_argument("--latent-prior", default=None,
                    help="npz from `fit-prior` (mean + covariance Cholesky): draw the "
                         "latent noise from the fitted code Gaussian instead of the "
                         "isotropic --noise-std draw")
    ap.add_argument("--no-normalize", action="store_true",
                    help="inputs are already in the training distribution; "
                         "skip 0.9-box normalization and output rescale")
    args = ap.parse_args(argv)

    if args.artifact:
        fixed = [flag for flag, v in (("--epoch", args.epoch), ("--batch", args.batch),
                                      ("--n-existing", args.n_existing),
                                      ("--points", args.points), ("--device", args.device))
                 if v is not None]
        if fixed:
            ap.error(f"{', '.join(fixed)}: fixed by the artifact, given with --config only")
        with open(args.artifact, "rb") as fh:
            data = fh.read()
        meta = artifact_meta(data)
        if (meta.get("data_parallel") or 0) > 1:
            raise SystemExit("infer drives single-process artifacts; re-export without "
                             "--data-parallel for CLI serving")
        batch, n_exist, zdim = meta["batch"], meta["n_existing"], meta["noise_size"]
        lg = _load_prior(args.latent_prior, zdim)  # checked before any completion
        f = load_completion(data)
        result = {"artifact": args.artifact, "device": meta["device"]}
    else:
        device = resolve_device(args.device or "cuda")
        with open(args.config) as fh:
            config = json.load(fh)
        model, epoch = restore_trained_model(config, args.epoch)
        batch, n_exist, zdim = args.batch or 64, args.n_existing or 1024, model.get_noise_size()
        lg = _load_prior(args.latent_prior, zdim)
        f = make_serving_fn(model, num_output_points=args.points or 2048, epoch=float(epoch),
                            device=device)
        result = {"config": args.config, "restored_epoch": epoch, "device": str(device)}

    rng = np.random.default_rng(args.seed)
    clouds, transforms = [], []
    for p in args.inputs:
        pts = np.asarray(load_ply(p), np.float32)
        if args.no_normalize:
            center, scale = np.zeros(3, np.float32), 1.0
        else:
            center, scale = get_scales(pts)
            pts = (pts - center) / scale
        transforms.append((center, scale))
        clouds.append(resample_pcd(pts, n_exist, rng).astype(np.float32))

    os.makedirs(args.out_dir, exist_ok=True)
    jobs = [(i, k) for i in range(len(clouds)) for k in range(args.samples)]
    written = []
    for start in range(0, len(jobs), batch):
        chunk = jobs[start:start + batch]
        ex = np.stack([clouds[i] for i, _ in chunk])
        if len(chunk) < batch:  # pad the tail to the fixed batch
            ex = np.concatenate([ex, np.repeat(ex[-1:], batch - len(chunk), 0)])
        if lg is not None:
            eps = rng.standard_normal((batch, zdim)).astype(np.float32)
            noise = lg.mean + eps @ lg.scale_tril.T
        elif args.noise_std > 0:
            noise = rng.standard_normal((batch, zdim)).astype(np.float32) * args.noise_std
        else:
            noise = np.zeros((batch, zdim), np.float32)
        comp = f(ex, noise, args.seed).cpu().numpy()
        for j, (i, k) in enumerate(chunk):
            center, scale = transforms[i]
            rec = comp[j] * scale + center
            stem = os.path.splitext(os.path.basename(args.inputs[i]))[0]
            name = (f"{stem}_completion.ply" if args.samples == 1
                    else f"{stem}_completion{k}.ply")
            path = os.path.join(args.out_dir, name)
            save_ply(path, np.asarray(rec, np.float32))
            written.append(path)
    print(json.dumps({**result, "inputs": len(clouds), "samples": args.samples,
                      "written": written}))
    return 0


def fit_prior_main(argv=None) -> int:
    """``python -m hyperpocket_tpu_torch.serving fit-prior``: fit the empirical
    latent Gaussian on the val split's missing halves and save it as the npz
    that ``infer --latent-prior`` reads."""
    ap = argparse.ArgumentParser(
        prog="python -m hyperpocket_tpu_torch.serving fit-prior",
        description="Fit the empirical latent prior of a trained model")
    ap.add_argument("-c", "--config", required=True,
                    help="training config json (reference schema)")
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--max-items", type=int, default=1024)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from hyperpocket_tpu_torch.data.base import get_datasets
    from hyperpocket_tpu_torch.eval.latent_stats import (
        collect_val_missing_halves,
        fit_latent_gaussian,
        save_latent_gaussian,
    )

    device = resolve_device(args.device)
    with open(args.config) as fh:
        config = json.load(fh)
    model, epoch = restore_trained_model(config, device=device)
    _, val_dict, _ = get_datasets(config["dataset"])
    try:
        halves = collect_val_missing_halves(val_dict, args.max_items)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    lg = fit_latent_gaussian(model, halves, args.batch_size, device=device)
    save_latent_gaussian(lg, args.out)
    print(json.dumps({"out": args.out, "epoch": epoch, "fitted_on": len(halves),
                      "dim": lg.dim}))
    return 0


def export_main(argv=None) -> int:
    """``python -m hyperpocket_tpu_torch.serving export``: checkpoint -> artifact + sidecar."""
    ap = argparse.ArgumentParser(
        prog="python -m hyperpocket_tpu_torch.serving export",
        description="Export a trained completion model as a torch.export artifact")
    ap.add_argument("-c", "--config", required=True,
                    help="training config json (reference schema)")
    ap.add_argument("--out", required=True, help="artifact output path")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n-existing", type=int, default=1024)
    ap.add_argument("--points", type=int, default=2048)
    ap.add_argument("--epoch", default=None,
                    help="restore policy: latest | best_val | <int> "
                         "(default: the config's experiments.epoch, else latest)")
    ap.add_argument("--data-parallel", type=int, default=None,
                    help="export the per-rank program of an N-rank data-parallel server "
                         "(N must divide --batch)")
    ap.add_argument("--device", default="cuda",
                    help="the device the artifact is traced on and serves on")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    with open(args.config) as fh:
        config = json.load(fh)
    model, epoch = restore_trained_model(config, args.epoch)
    data = export_completion(model, batch=args.batch, n_existing=args.n_existing,
                             num_output_points=args.points, epoch=float(epoch),
                             data_parallel=args.data_parallel, device=device)
    with open(args.out, "wb") as fh:
        fh.write(data)
    meta = {
        "artifact": args.out,
        "bytes": len(data),
        "restored_epoch": epoch,
        "batch": args.batch,
        "n_existing": args.n_existing,
        "num_output_points": args.points,
        "noise_size": model.get_noise_size(),
        "data_parallel": args.data_parallel,
        "platform": device.type,
        "compute_dtype": model.compute_dtype,
    }
    with open(args.out + ".json", "w") as fh:
        json.dump(meta, fh, indent=1)
    print(json.dumps(meta))
    return 0


def main(argv=None) -> int:
    """Subcommands ``export`` (also the bare flags), ``infer`` and ``fit-prior``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["infer"]:
        return infer_main(argv[1:])
    if argv[:1] == ["fit-prior"]:
        return fit_prior_main(argv[1:])
    if argv[:1] == ["export"]:
        argv = argv[1:]
    return export_main(argv)


if __name__ == "__main__":
    sys.exit(main())
