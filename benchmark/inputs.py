"""What the benchmark makes from a seed: the model's weights, the partial
scans it serves and the training corpus.

Weights and scans are made on the card from a ``torch.Generator`` seeded
with the run's seed, in a few large calls; the training corpus is made on
the host with numpy from a fixed corpus seed, written once into the
checkout and made again in memory for the reference.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch

from benchmark.reference.model import ENCODER_LAYERS, HYPER_LAYERS, xavier_relu_bound

ENCODER_WIDTHS = (3, 64, 128, 256, 512, 512)
FC = 512
HYPER_WIDTHS = (64, 128, 512, 1024, 2048)
BIAS_BOUND = 0.05  # biases are drawn too, so that a fault in one shows
CATEGORY = "03001627"  # chair


def param_shapes(model: dict) -> list[tuple[str, tuple[int, ...]]]:
    """The model's parameters as the published layout names them, in the
    state-dict naming, each weight (out, in)."""
    rand = int(model["random_encoder"]["output_size"])
    real = int(model["real_encoder"]["output_size"])
    shapes = []
    for prefix, size in (("random_encoder", rand), ("real_encoder", real)):
        if size <= 0:
            continue
        for i in range(ENCODER_LAYERS):
            shapes += [(f"{prefix}.conv.{i}.weight", (ENCODER_WIDTHS[i + 1], ENCODER_WIDTHS[i])),
                       (f"{prefix}.conv.{i}.bias", (ENCODER_WIDTHS[i + 1],))]
        shapes += [(f"{prefix}.fc.weight", (FC, FC)), (f"{prefix}.fc.bias", (FC,))]
        for head in ("mu", "std"):
            shapes += [(f"{prefix}.{head}.weight", (size, FC)), (f"{prefix}.{head}.bias", (size,))]
    dims = (rand + real, *HYPER_WIDTHS)
    for i in range(HYPER_LAYERS):
        shapes += [(f"hyper_network.trunk.{i}.weight", (dims[i + 1], dims[i])),
                   (f"hyper_network.trunk.{i}.bias", (dims[i + 1],))]
    ch = [3, *model["target_network"]["layer_out_channels"], 3]
    flat = sum((ch[i - 1] + 1) * ch[i] for i in range(1, len(ch)))
    shapes += [("hyper_network.heads.weight", (flat, HYPER_WIDTHS[-1])),
               ("hyper_network.heads.bias", (flat,))]
    return shapes


def _head_row_bounds(model: dict) -> torch.Tensor:
    """A Xavier-ReLU bound a row of the hypernetwork's head: each target
    layer's weight and bias rows are a layer of their own (fan-out = their rows)."""
    ch = [3, *model["target_network"]["layer_out_channels"], 3]
    sizes = [(ch[i - 1] + 1) * ch[i] for i in range(1, len(ch))]
    return torch.cat([torch.full((s,), xavier_relu_bound(HYPER_WIDTHS[-1], s)) for s in sizes])


def make_weights(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """fp32 weights from ``seed``: one uniform draw on ``device`` for all of
    them, scaled to the Xavier-ReLU bound of each layer (the model's own
    initialisation) and to +-BIAS_BOUND for the biases."""
    shapes = param_shapes(model)
    total = sum(int(np.prod(s)) for _, s in shapes)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=g, device=device).mul_(2).sub_(1)
    out, off = {}, 0
    for name, shape in shapes:
        n = int(np.prod(shape))
        w = flat[off:off + n].view(shape)
        off += n
        if name == "hyper_network.heads.weight":
            w.mul_(_head_row_bounds(model).to(device)[:, None])
        elif len(shape) == 2:
            w.mul_(xavier_relu_bound(shape[1], shape[0]))
        else:
            w.mul_(BIAS_BOUND)
        out[name] = w
    return out


def make_scans(generator: torch.Generator, count: int, n_gt: int, n_partial: int):
    """``count`` synthetic shapes and their halves, on the generator's device:
    (gt (count, n_gt, 3), existing, missing (count, n_partial, 3)).

    A shape is the surface of an ellipsoid with semi-axes in [0.15, 0.45]
    (inside the unit sphere, as a normalised corpus holds it); a random
    plane through its centre cuts it, and each side is resampled with
    replacement to ``n_partial`` points, as the 3D-EPN slicer writes halves.
    """
    dev = generator.device
    axes = torch.rand((count, 1, 3), generator=generator, device=dev) * 0.3 + 0.15
    dirs = torch.randn((count, n_gt, 3), generator=generator, device=dev)
    gt = dirs / dirs.norm(dim=-1, keepdim=True).clamp_min(1e-12) * axes
    normal = torch.randn((count, 3, 1), generator=generator, device=dev)
    side = (gt @ normal)[..., 0] > 0

    def half(mask):
        weight = mask.float() + (mask.sum(1, keepdim=True) == 0).float()
        idx = torch.multinomial(weight, n_partial, replacement=True, generator=generator)
        return torch.gather(gt, 1, idx[..., None].expand(-1, -1, 3))

    return gt, half(side), half(~side)


# ---------------------------------------------------------------------------
# The training corpus: a 3D-EPN chair tree


def corpus_arrays(shapes: int, samples: int, n_gt: int, n_partial: int, corpus_seed: int):
    """(gt (S, n_gt, 3), existing, missing (S, samples, n_partial, 3)) float32,
    made on the host with numpy from ``corpus_seed``: the same shapes as
    ``make_scans``, each cut by ``samples`` planes."""
    rng = np.random.default_rng(corpus_seed)
    axes = rng.uniform(0.15, 0.45, (shapes, 1, 3))
    dirs = rng.standard_normal((shapes, n_gt, 3))
    gt = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True) * axes).astype(np.float32)
    normals = rng.standard_normal((shapes, samples, 3))
    existing = np.empty((shapes, samples, n_partial, 3), np.float32)
    missing = np.empty_like(existing)
    for s in range(shapes):
        side = gt[s] @ normals[s].T > 0  # (n_gt, samples)
        for k in range(samples):
            for out, mask in ((existing, side[:, k]), (missing, ~side[:, k])):
                pool = np.flatnonzero(mask)
                pool = pool if pool.size else np.arange(n_gt)
                out[s, k] = gt[s][pool[rng.integers(0, pool.size, n_partial)]]
    return gt, existing, missing


def shape_name(s: int) -> str:
    return f"c{s:05d}"


def _write_ply(path: Path, points: np.ndarray) -> None:
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {points.shape[0]}\n"
              "property float x\nproperty float y\nproperty float z\nend_header\n")
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(np.ascontiguousarray(points, "<f4").tobytes())


def ensure_corpus(root: Path, spec: dict) -> Path:
    """The 3D-EPN tree of ``spec`` under ``root`` (written once, then reused):
    ``slices/{gt,existing,missing}/03001627/`` (``<name>.ply`` and
    ``<k>~<name>.ply``) and a split CSV that labels every shape ``train``, as
    3D-EPN's slicer pools its train and val shapes into one tree."""
    key = "_".join(str(spec[k]) for k in ("shapes", "samples", "n_gt", "n_partial", "corpus_seed"))
    path = root / f"3depn_{key}"
    if (path / "COMPLETE").exists():
        return path
    tmp = root / f".3depn_{key}.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    gt, existing, missing = corpus_arrays(spec["shapes"], spec["samples"], spec["n_gt"],
                                          spec["n_partial"], spec["corpus_seed"])
    dirs = {kind: tmp / "slices" / kind / CATEGORY for kind in ("gt", "existing", "missing")}
    for d in dirs.values():
        d.mkdir(parents=True)
    rows = ["id,synsetId,modelId,split"]
    for s in range(gt.shape[0]):
        name = shape_name(s)
        _write_ply(dirs["gt"] / f"{name}.ply", gt[s])
        for k in range(existing.shape[1]):
            _write_ply(dirs["existing"] / f"{k}~{name}.ply", existing[s, k])
            _write_ply(dirs["missing"] / f"{k}~{name}.ply", missing[s, k])
        rows.append(f"{s},{CATEGORY},{name},train")
    (tmp / "shapenet-official-split.csv").write_text("\n".join(rows) + "\n")
    (tmp / "COMPLETE").write_text(json.dumps(spec) + "\n")
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path
