"""Evaluators over the ``fixed/`` artifact directory: MMD, UHD, TMD.

Port of ``hyperpocket_tpu/eval/evaluation.py`` (reference
``utils/evaluation/{mmd,completeness,total_mutual_diff,chamfer}.py``):

* **MMD**: for each reference gt cloud, the best (mean NN distance both
  ways) over all generated clouds.
* **UHD**: directed Hausdorff from the existing half to each completion,
  averaged per object, then over objects.
* **TMD**: per object, the sum of the symmetric Chamfer over its completions'
  unordered pairs, times 2/(k-1), averaged over objects.

The inner ops are ``ops/nn.py``'s dispatchers, so on a card the clouds run
K3. Every function runs on the card unless ``device`` names another (and
raises without CUDA). The artifact layout is the
``fixed`` experiment's: sorted ``*_reconstruction.npy`` files in groups of k
per object, saved as (3, N), and ``*_existing.npy``.
"""

from __future__ import annotations

import glob
from os.path import join

import numpy as np
import torch

from hyperpocket_tpu_torch.ops.nn import (
    chamfer_per_cloud_auto,
    directed_hausdorff_auto,
    nn_min_dists,
)
from hyperpocket_tpu_torch.serving import resolve_device


def minimum_matching_distance(sample_pcs: np.ndarray, ref_pcs: np.ndarray, batch_size: int,
                              device="cuda"):
    """(mmd, per-ref best distances), the definition of reference mmd.py:23-47.

    Eight refs times ``batch_size`` samples go through one ``nn_min_dists``
    call; the per-ref minima combine across calls, which is order-free.
    """
    n_ref, n_pts, dim = ref_pcs.shape
    _, n_pts_s, dim_s = sample_pcs.shape
    if n_pts != n_pts_s or dim != dim_s:
        raise ValueError("Incompatible size of point-clouds.")
    r_block = 8
    device = resolve_device(device)
    samples = torch.as_tensor(np.asarray(sample_pcs), device=device)
    refs_all = torch.as_tensor(np.asarray(ref_pcs), device=device)
    best = np.full(n_ref, np.inf, np.float64)
    for r0 in range(0, n_ref, r_block):
        refs = refs_all[r0:r0 + r_block]
        r = refs.shape[0]
        for s0 in range(0, samples.shape[0], batch_size):
            chunk = samples[s0:s0 + batch_size]
            s = chunk.shape[0]
            refs_b = refs[:, None].expand(r, s, n_pts, dim).reshape(r * s, n_pts, dim)
            chunk_b = chunk[None].expand(r, s, n_pts, dim).reshape(r * s, n_pts, dim)
            d_ref_to_s, d_s_to_ref = nn_min_dists(refs_b, chunk_b)
            cd = (d_ref_to_s.mean(dim=1) + d_s_to_ref.mean(dim=1)).reshape(r, s)
            np.minimum.at(best, np.arange(r0, r0 + r), cd.amin(dim=1).cpu().numpy())
    matched = [float(v) for v in best]
    return float(np.mean(matched)), matched


def _load_grouped_reconstructions(shape_dir: str, group: int | None = None) -> np.ndarray:
    """Sorted *_reconstruction.npy -> (n_objects, group, N, 3).

    ``group`` defaults to the per-object completion count read from the
    ``<cat>_<obj>_<j>_reconstruction.npy`` names (``fixed``'s
    ``noises_per_item``).
    """
    paths = sorted(glob.glob(join(shape_dir, "*reconstruction.npy")))
    if not paths:
        raise FileNotFoundError(
            f"no *reconstruction.npy under {shape_dir} — run the 'fixed' "
            f"experiment first (it writes the completions UHD/TMD consume)")
    if group is None:
        js = {int(p.rsplit("_", 2)[-2]) for p in paths}
        group = max(js) + 1
        if js != set(range(group)):
            raise ValueError(
                f"fixed/ reconstruction indices are not dense 0..{group - 1}: "
                f"{sorted(js)} — partial or mixed fixed/ outputs under {shape_dir}")
    if len(paths) % group:
        raise ValueError(
            f"{len(paths)} reconstructions under {shape_dir} do not divide "
            f"into groups of {group} — partial fixed/ outputs?")
    n_objects = len(paths) // group
    out = [[np.load(paths[i * group + j]).T for j in range(group)] for i in range(n_objects)]
    return np.asarray(out, dtype=np.float32)


def mmd_process(shape_dir: str, dataset, batch_size: int = 64, device="cuda") -> float:
    """Reference mmd.process (mmd.py:50-69): fixed/ samples vs the dataset's gt."""
    ref_pcs = np.stack([data[2] for data in dataset], axis=0)
    paths = sorted(glob.glob(join(shape_dir, "*reconstruction.npy")))
    sample_pcs = np.stack([np.load(p).T for p in paths], axis=0)
    mmd, _ = minimum_matching_distance(sample_pcs, ref_pcs, batch_size, device)
    return mmd


def uhd_process(shape_dir: str, group: int | None = None, device="cuda") -> float:
    """Mean directed Hausdorff existing -> completions (completeness.py:63-89)."""
    device = resolve_device(device)
    gen = torch.as_tensor(_load_grouped_reconstructions(shape_dir, group), device=device)
    existing_paths = sorted(glob.glob(join(shape_dir, "*existing.npy")))
    existing = torch.as_tensor(
        np.asarray([np.load(p).T for p in existing_paths], dtype=np.float32), device=device)
    o, k = gen.shape[0], gen.shape[1]
    ex_b = existing[:, None].expand(o, k, *existing.shape[1:]).reshape(o * k, *existing.shape[1:])
    uhd = directed_hausdorff_auto(ex_b, gen.reshape(o * k, *gen.shape[2:]))
    vals = uhd.reshape(o, k).mean(dim=1).cpu().numpy()
    return float(np.mean([float(v) for v in vals]))


def tmd_process(shape_dir: str, group: int | None = None, device="cuda") -> float:
    """Total mutual difference among completions (total_mutual_diff.py:27-61)."""
    device = resolve_device(device)
    gen = torch.as_tensor(_load_grouped_reconstructions(shape_dir, group), device=device)
    o, k = gen.shape[0], gen.shape[1]
    ii, jj = np.triu_indices(k, 1)
    a = gen[:, ii].reshape(o * len(ii), *gen.shape[2:])
    b = gen[:, jj].reshape(o * len(jj), *gen.shape[2:])
    pair_cd = chamfer_per_cloud_auto(a, b).reshape(o, len(ii))
    vals = (pair_cd.sum(dim=1) * 2.0 / (k - 1)).cpu().numpy()
    return float(np.mean([float(v) for v in vals]))


def compute_trimesh_chamfer(gt_points: np.ndarray, gen_points: np.ndarray,
                            offset: float = 0, scale: float = 1, device="cuda") -> float:
    """Symmetric mean-squared-NN Chamfer (reference chamfer.py:8-31)."""
    device = resolve_device(device)
    gen_points = np.asarray(gen_points) / scale - offset
    cd = chamfer_per_cloud_auto(torch.as_tensor(np.asarray(gt_points), device=device)[None],
                                torch.as_tensor(gen_points, device=device)[None])
    return float(cd[0])
