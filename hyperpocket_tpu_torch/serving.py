"""Completion serving: existing half-cloud + latent noise -> completed cloud.

Port of ``hyperpocket_tpu/serving.py``. ``make_serving_fn`` returns
``f(existing (B, N, 3) f32, noise (B, Z) f32, seed int) ->
(B, num_output_points, 3) f32`` with the (serving-cast) parameters closed
over. The seed seeds a ``torch.Generator`` on the serving device that draws
the target network's ball points; a fixed seed gives a fixed completion, but
not the JAX package's bits for the same seed.

CLI, PLY in and completion PLY out::

    python -m hyperpocket_tpu_torch.serving infer --config settings/config_3depn_chair.json \\
        --inputs scan1.ply scan2.ply --out-dir completions/ \\
        [--epoch best_val] [--batch 64] [--n-existing 1024] [--points 2048] \\
        [--samples 4 --noise-std 0.13] [--seed 0] [--no-normalize] [--device cuda]

One interface difference from the JAX CLI: the JAX ``infer`` reads a
``jax.export`` artifact, and its ``export`` step takes ``--config``,
``--epoch``, ``--batch``, ``--n-existing`` and ``--points``. This ``infer``
takes those flags itself and restores the JAX-layout checkpoint of the
config's results tree (``train/checkpoint.py``); the port has no artifact
export yet. Inputs are normalised into the 0.9 box like the real-scan
dataset and completions are mapped back by inverting that transform; the
tail of the jobs is padded to the fixed batch. ``--device`` defaults to
``cuda`` and raises when CUDA is absent.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
from collections.abc import Mapping

import numpy as np
import torch

from hyperpocket_tpu_torch.data.base import resample_pcd
from hyperpocket_tpu_torch.data.plyio import load_ply, save_ply
from hyperpocket_tpu_torch.data.real_data import get_scales
from hyperpocket_tpu_torch.models.full_model import FullModel
from hyperpocket_tpu_torch.train.checkpoint import restore_trained_model


def resolve_device(device: str | torch.device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def make_serving_fn(model: FullModel, params_or_module: FullModel | Mapping | None = None, *,
                    num_output_points: int = 2048, epoch: float = 1e9,
                    device: str | torch.device = "cuda"):
    """``f(existing, noise, seed) -> completion`` with the parameters closed over.

    ``params_or_module``: a ``FullModel`` holding the weights, a state_dict
    to load into a copy of ``model``, or None for ``model``'s own weights.
    They are cast once to the compute dtype (``serving_params``) and moved
    to ``device``. ``epoch`` feeds the progressive ball normalisation; past
    the schedule (the default) every ball point lies on the unit sphere.
    """
    device = resolve_device(device)
    if params_or_module is None:
        net = model
    elif isinstance(params_or_module, FullModel):
        net = params_or_module
    else:
        net = copy.deepcopy(model)
        net.load_state_dict(params_or_module)
    net = net.serving_params().to(device)
    epoch = float(epoch)

    def completion(existing, noise, seed: int) -> torch.Tensor:
        generator = torch.Generator(device=device).manual_seed(int(seed))
        existing = torch.as_tensor(existing, dtype=torch.float32, device=device)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=device)
        return net.apply(existing, None, generator, epoch,
                         num_output_points=num_output_points, training=False, noise=noise)

    return completion


def infer_main(argv=None) -> int:
    """``python -m hyperpocket_tpu_torch.serving infer``: PLY in -> completion PLY out."""
    ap = argparse.ArgumentParser(
        prog="python -m hyperpocket_tpu_torch.serving infer",
        description="Complete partial point clouds from PLY files with a trained model")
    ap.add_argument("-c", "--config", required=True,
                    help="training config json (reference schema) naming the results tree")
    ap.add_argument("--inputs", nargs="+", required=True, help="partial-cloud .ply files")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--epoch", default=None,
                    help="restore policy: latest | best_val | <int> "
                         "(default: the config's experiments.epoch, else latest)")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n-existing", type=int, default=1024)
    ap.add_argument("--points", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0,
                    help="ball-sampling/noise seed (fixed seed + zero noise "
                         "=> deterministic completions)")
    ap.add_argument("--samples", type=int, default=1,
                    help="completions per input (fresh latent noise each)")
    ap.add_argument("--noise-std", type=float, default=0.0,
                    help="latent noise std (the reference's fixed experiment "
                         "uses 0.13; 0 = zero-noise completion)")
    ap.add_argument("--no-normalize", action="store_true",
                    help="inputs are already in the training distribution; "
                         "skip 0.9-box normalization and output rescale")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    with open(args.config) as fh:
        config = json.load(fh)
    model, epoch = restore_trained_model(config, args.epoch)
    f = make_serving_fn(model, num_output_points=args.points, epoch=float(epoch),
                        device=device)
    batch, zdim = args.batch, model.get_noise_size()

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
        clouds.append(resample_pcd(pts, args.n_existing, rng).astype(np.float32))

    os.makedirs(args.out_dir, exist_ok=True)
    jobs = [(i, k) for i in range(len(clouds)) for k in range(args.samples)]
    written = []
    for start in range(0, len(jobs), batch):
        chunk = jobs[start:start + batch]
        ex = np.stack([clouds[i] for i, _ in chunk])
        if len(chunk) < batch:  # pad the tail to the fixed batch
            ex = np.concatenate([ex, np.repeat(ex[-1:], batch - len(chunk), 0)])
        if args.noise_std > 0:
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
    print(json.dumps({"config": args.config, "restored_epoch": epoch, "inputs": len(clouds),
                      "samples": args.samples, "device": str(device), "written": written}))
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["infer"]:
        return infer_main(argv[1:])
    raise SystemExit("usage: python -m hyperpocket_tpu_torch.serving infer --config ... "
                     "(artifact export and fit-prior are not ported yet)")


if __name__ == "__main__":
    sys.exit(main())
