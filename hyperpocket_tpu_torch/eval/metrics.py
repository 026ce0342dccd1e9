"""Generative point-cloud metrics: MMD/Coverage over CD and EMD, 1-NNA, JSD.

Port of ``hyperpocket_tpu/eval/metrics.py`` (reference ``utils/metrics.py``,
after PointFlow):

* ``EMD_CD``: paired CD (mean of the minima both ways) and normalised EMD.
* ``pairwise_emd_cd``: the (N_sample, N_ref) CD and EMD matrices, ``row_block``
  sample rows against each ref chunk per call.
* ``pairwise_emd_cd_multi``: per-object (G, R, S) matrices from one flat list
  of pairs, dispatched ``pair_block`` pairs at a time (the last block padded
  with pair 0 and cut), the clouds uploaded once and gathered on the device.
  On a card each dispatch runs K3 once (``ops/nn.py::chamfer_per_cloud_auto``)
  and K6 once (``ops/emd.py::earth_mover_distance``).
* ``mmd_cov``/``mmd_cov_multi``: MMD (fidelity) = mean over refs of the best
  sample distance; coverage = share of refs that are some sample's argmin.
* ``knn``: 1-NN two-sample accuracy, with ``topk`` over the k smallest.
* JSD on 28^3 occupancy grids: numpy, a copy of the JAX package's.

Clouds may be numpy arrays or tensors. ``device`` places them; without it a
tensor stays where it is and numpy goes to the card (raising without CUDA).
Matrices come back as tensors on that device, except
``pairwise_emd_cd_multi``, which returns numpy as the JAX package does. The
small post-processing of matrices (``mmd_cov``, ``knn``) keeps numpy on the
host.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch
from scipy.stats import entropy

from hyperpocket_tpu_torch.ops.emd import earth_mover_distance
from hyperpocket_tpu_torch.ops.nn import chamfer_per_cloud_auto
from hyperpocket_tpu_torch.serving import resolve_device


def _tensor(x, device=None) -> torch.Tensor:
    """Clouds on ``device``; without one a tensor stays put and numpy goes to the card."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    device = resolve_device("cuda" if device is None else device)
    return torch.as_tensor(np.asarray(x), device=device)


def _host_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def EMD_CD(sample_pcs, ref_pcs, batch_size: int, reduced: bool = True, device=None) -> dict:
    sample_pcs, ref_pcs = _tensor(sample_pcs, device), _tensor(ref_pcs, device)
    n_sample, n_ref = sample_pcs.shape[0], ref_pcs.shape[0]
    if n_sample != n_ref:
        raise ValueError(f"REF:{n_ref} SMP:{n_sample}")
    cd_list, emd_list = [], []
    for start in range(0, n_sample, batch_size):
        s = sample_pcs[start:start + batch_size]
        r = ref_pcs[start:start + batch_size]
        cd_list.append(chamfer_per_cloud_auto(s, r))
        emd_list.append(earth_mover_distance(s, r))
    cd, emd = torch.cat(cd_list), torch.cat(emd_list)
    if reduced:
        cd, emd = cd.mean(), emd.mean()
    return {"MMD-CD": cd, "MMD-EMD": emd}


def pairwise_emd_cd(sample_pcs, ref_pcs, batch_size: int, row_block: int = 8, device=None):
    """(N_sample, N_ref) CD and EMD matrices; entry [i, j] = op(sample_i, ref_j)."""
    sample_pcs, ref_pcs = _tensor(sample_pcs, device), _tensor(ref_pcs, device)
    n_sample, n_ref = sample_pcs.shape[0], ref_pcs.shape[0]
    batch_size = min(batch_size, n_ref)
    rows_cd, rows_emd = [], []
    for i0 in range(0, n_sample, row_block):
        samp = sample_pcs[i0:i0 + row_block]
        row_cd, row_emd = [], []
        for start in range(0, n_ref, batch_size):
            ref_chunk = ref_pcs[start:start + batch_size]
            r, c = samp.shape[0], ref_chunk.shape[0]
            a = samp[:, None].expand(r, c, *samp.shape[1:]).reshape(r * c, *samp.shape[1:])
            b = ref_chunk[None].expand(r, c, *ref_chunk.shape[1:]).reshape(
                r * c, *ref_chunk.shape[1:])
            row_cd.append(chamfer_per_cloud_auto(a, b).reshape(r, c))
            row_emd.append(earth_mover_distance(a, b).reshape(r, c))
        rows_cd.append(torch.cat(row_cd, dim=1))
        rows_emd.append(torch.cat(row_emd, dim=1))
    return torch.cat(rows_cd), torch.cat(rows_emd)


def _pair_ops(rows, cols, idx_r, idx_c, timings: dict | None = None):
    """CD and EMD of the pairs (rows[idx_r[p]], cols[idx_c[p]]), in that operand order.

    The approximate EMD is not symmetric, so the order matters. With
    ``timings`` the CD and EMD wall times (synchronised) are added under
    ``"cd_s"`` and ``"emd_s"``.
    """
    a, b = rows[idx_r], cols[idx_c]
    if timings is None:
        return chamfer_per_cloud_auto(a, b), earth_mover_distance(a, b)
    _sync(a.device)
    t0 = time.perf_counter()
    cd = chamfer_per_cloud_auto(a, b)
    _sync(a.device)
    t1 = time.perf_counter()
    emd = earth_mover_distance(a, b)
    _sync(a.device)
    timings["cd_s"] = timings.get("cd_s", 0.0) + t1 - t0
    timings["emd_s"] = timings.get("emd_s", 0.0) + time.perf_counter() - t1
    return cd, emd


def pairwise_emd_cd_multi(row_pcs, col_sets, pair_block: int = 512, device=None,
                          timings: dict | None = None, mesh=None):
    """(G, R, S) CD and EMD matrices: entry [g, i, j] = op(row_g_i, col_sets[g, j]).

    ``row_pcs`` is one shared (R, Q, 3) set or per-object (G, R, Q, 3) sets.
    All G*R*S pairs are enumerated flat and dispatched ``pair_block`` at a
    time; the last dispatch is padded with pair 0 and its tail cut. ``mesh``
    (sharding the pairs over devices) is not ported.
    """
    if mesh is not None:
        raise NotImplementedError(
            "pairwise_emd_cd_multi over a device mesh comes with the parallelism slice "
            "(ROADMAP.md, open items: 'parallel_data')")
    cols = _tensor(col_sets, device)
    device = cols.device
    G, S = cols.shape[:2]
    col_flat = cols.reshape(G * S, *cols.shape[2:])
    rows = _tensor(row_pcs, device)
    per_object_rows = rows.ndim == 4
    if per_object_rows:
        R = rows.shape[1]
        row_flat = rows.reshape(G * R, *rows.shape[2:])
    else:
        R = rows.shape[0]
        row_flat = rows
    n = G * R * S
    cd_chunks, emd_chunks = [], []
    for p0 in range(0, n, pair_block):
        idx = np.arange(p0, min(p0 + pair_block, n), dtype=np.int64)
        if idx.size < pair_block:
            idx = np.concatenate([idx, np.zeros(pair_block - idx.size, np.int64)])
        g, rem = np.divmod(idx, R * S)
        i, j = np.divmod(rem, S)
        r_idx = g * R + i if per_object_rows else i
        c, e = _pair_ops(row_flat, col_flat, torch.as_tensor(r_idx, device=device),
                         torch.as_tensor(g * S + j, device=device), timings)
        cd_chunks.append(c)
        emd_chunks.append(e)
    cd = torch.cat(cd_chunks)[:n].cpu().numpy()
    emd = torch.cat(emd_chunks)[:n].cpu().numpy()
    return cd.reshape(G, R, S), emd.reshape(G, R, S)


def mmd_cov(all_dist) -> dict:
    """all_dist (N_sample, N_ref) -> fidelity/coverage stats."""
    all_dist = _host_tensor(all_dist)
    n_ref = all_dist.shape[1]
    min_val_fromsmp, min_idx = torch.min(all_dist, dim=1)
    min_val = torch.amin(all_dist, dim=0)
    cov = float(torch.unique(min_idx).numel()) / float(n_ref)
    return {
        "mmd(Fidelity)": min_val.mean(),
        "cov(Coverage)": torch.tensor(cov),
        "mmd_smp": min_val_fromsmp.mean(),
    }


def knn(mxx, mxy, myy, k: int, sqrt: bool = False) -> dict:
    """1-NN two-sample test stats (reference metrics.py:162-191)."""
    mxx, mxy, myy = _host_tensor(mxx), _host_tensor(mxy), _host_tensor(myy)
    n0, n1 = mxx.shape[0], myy.shape[0]
    label = torch.cat([torch.ones(n0, dtype=mxx.dtype), torch.zeros(n1, dtype=mxx.dtype)]).to(
        mxx.device)
    m = torch.cat([torch.cat([mxx, mxy], dim=1), torch.cat([mxy.T, myy], dim=1)], dim=0)
    if sqrt:
        m = torch.sqrt(torch.abs(m))
    m = m + torch.diag(torch.full((n0 + n1,), float("inf"), dtype=m.dtype, device=m.device))
    # the k smallest per column (the reference's .topk(k, 0, False))
    idx = torch.topk(m, k, dim=0, largest=False).indices
    count = label[idx].sum(dim=0)
    pred = (count >= k / 2.0).to(torch.float32)
    label = label.to(torch.float32)
    tp = (pred * label).sum()
    fp = (pred * (1 - label)).sum()
    fn = ((1 - pred) * label).sum()
    tn = ((1 - pred) * (1 - label)).sum()
    return {
        "tp": tp, "fp": fp, "fn": fn, "tn": tn,
        "precision": tp / (tp + fp + 1e-10),
        "recall": tp / (tp + fn + 1e-10),
        "acc_t": tp / (tp + fn + 1e-10),
        "acc_f": tn / (tn + fp + 1e-10),
        "acc": (pred == label).to(torch.float32).mean(),
    }


def knn_batch_1nna(mxx, mxy, myy) -> dict:
    """``knn(mxx, mxy[g], myy[g], 1)`` for every g, stacked per key."""
    per = [knn(mxx, mxy[g], myy[g], 1) for g in range(len(mxy))]
    return {key: torch.stack([p[key] for p in per]) for key in per[0]}


def compute_all_metrics(sample_pcs, ref_pcs, batch_size: int, device=None) -> dict:
    """MMD/COV over CD and EMD; the matrix is built as (ref, sample), then transposed."""
    m_rs_cd, m_rs_emd = pairwise_emd_cd(ref_pcs, sample_pcs, batch_size, device=device)
    results = {f"{k}-CD": v for k, v in mmd_cov(m_rs_cd.T).items()}
    results.update({f"{k}-EMD": v for k, v in mmd_cov(m_rs_emd.T).items()})
    return results


def compute_all_metrics_multi(sample_sets, ref_pcs, pair_block: int = 512,
                              device=None) -> list[dict]:
    """Per-object ``compute_all_metrics`` from one flat-pair matrix build."""
    m_cd, m_emd = pairwise_emd_cd_multi(ref_pcs, sample_sets, pair_block, device=device)
    return mmd_cov_multi(m_cd, m_emd)


def mmd_cov_multi(m_cd, m_emd) -> list[dict]:
    """``mmd_cov`` of each object's transposed (S, R) matrix, from stacked (G, R, S)."""
    out: list[dict] = [{} for _ in range(len(m_cd))]
    n_ref = m_cd.shape[1]
    for tag, m in (("CD", m_cd), ("EMD", m_emd)):
        m = _host_tensor(m).transpose(1, 2)  # (G, S, R)
        min_val_fromsmp, min_idx = torch.min(m, dim=2)
        min_val = torch.amin(m, dim=1)
        mmd, mmd_smp = min_val.mean(dim=1), min_val_fromsmp.mean(dim=1)
        for g, res in enumerate(out):
            res[f"mmd(Fidelity)-{tag}"] = float(mmd[g])
            res[f"cov(Coverage)-{tag}"] = float(torch.unique(min_idx[g]).numel()) / float(n_ref)
            res[f"mmd_smp-{tag}"] = float(mmd_smp[g])
    return out


# ---------------------------------------------------------------------------
# JSD via occupancy grids (reference metrics.py:246-359); numpy


def unit_cube_grid_point_cloud(resolution: int, clip_sphere: bool = False):
    spacing = 1.0 / float(resolution - 1)
    ax = np.arange(resolution, dtype=np.float32) * spacing - 0.5
    grid = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1).astype(np.float32)
    if clip_sphere:
        grid = grid.reshape(-1, 3)
        grid = grid[np.linalg.norm(grid, axis=1) <= 0.5]
    return grid, spacing


def entropy_of_occupancy_grid(pclouds, grid_resolution: int, in_sphere: bool = False,
                              verbose: bool = False):
    epsilon = 1e-3
    bound = 0.5 + epsilon
    pclouds = np.asarray(pclouds)
    if verbose and (abs(np.max(pclouds)) > bound or abs(np.min(pclouds)) > bound):
        warnings.warn("Point-clouds are not in unit cube.")
    if in_sphere and verbose and np.max(np.sqrt(np.sum(pclouds**2, axis=2))) > bound:
        warnings.warn("Point-clouds are not in unit sphere.")

    grid_coordinates, spacing = unit_cube_grid_point_cloud(grid_resolution, in_sphere)
    grid_coordinates = grid_coordinates.reshape(-1, 3)

    # the grid is regular, so a point's nearest full-grid cell is its rounded
    # coordinates; a point whose rounded cell lies outside the sphere falls
    # back to a KD query over the kept cells
    res = grid_resolution
    if pclouds.dtype == object or pclouds.ndim != 3:
        from scipy.spatial import cKDTree

        tree = cKDTree(grid_coordinates)
        grid_counters = np.zeros(len(grid_coordinates))
        grid_bernoulli_rvars = np.zeros(len(grid_coordinates))
        for pc in pclouds:
            _, indices = tree.query(pc)
            uniq, counts = np.unique(indices, return_counts=True)
            grid_counters[uniq] += counts
            grid_bernoulli_rvars[uniq] += 1
        return _finish_entropy(grid_counters, grid_bernoulli_rvars, len(pclouds))
    pts = pclouds.reshape(-1, 3)
    ijk = np.clip(np.rint((pts + 0.5) / spacing), 0, res - 1).astype(np.int64)
    full_flat = (ijk[:, 0] * res + ijk[:, 1]) * res + ijk[:, 2]
    if in_sphere:
        ax = np.arange(res, dtype=np.float32) * spacing - 0.5
        full_grid = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1).reshape(-1, 3)
        kept = np.linalg.norm(full_grid, axis=1) <= 0.5
        full_to_kept = np.full(res**3, -1, dtype=np.int64)
        full_to_kept[kept] = np.arange(int(kept.sum()))
        indices_all = full_to_kept[full_flat]
        miss = indices_all < 0
        if miss.any():
            from scipy.spatial import cKDTree

            _, fb = cKDTree(grid_coordinates).query(pts[miss])
            indices_all[miss] = fb
    else:
        indices_all = full_flat
    indices_all = indices_all.reshape(pclouds.shape[0], pclouds.shape[1])

    grid_counters = np.zeros(len(grid_coordinates))
    grid_bernoulli_rvars = np.zeros(len(grid_coordinates))
    np.add.at(grid_counters, indices_all.ravel(), 1)
    srt = np.sort(indices_all, axis=1)
    first = np.ones_like(srt, dtype=bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    np.add.at(grid_bernoulli_rvars, srt[first], 1)
    return _finish_entropy(grid_counters, grid_bernoulli_rvars, len(pclouds))


def _finish_entropy(grid_counters, grid_bernoulli_rvars, n_clouds: int):
    n = float(n_clouds)
    occupied = grid_bernoulli_rvars[grid_bernoulli_rvars > 0]
    # Bernoulli entropy per occupied cell, with 0 ln 0 := 0
    p = occupied / n
    q = 1.0 - p
    with np.errstate(divide="ignore", invalid="ignore"):
        h = -(np.where(p > 0, p * np.log(p), 0.0) + np.where(q > 0, q * np.log(q), 0.0))
    return float(np.sum(h)) / len(grid_counters), grid_counters


def _jsdiv(p, q):
    def _kldiv(a, b):
        idx = np.logical_and(a > 0, b > 0)
        return np.sum(a[idx] * np.log2(a[idx] / b[idx]))

    p = p / np.sum(p)
    q = q / np.sum(q)
    m = 0.5 * (p + q)
    return 0.5 * (_kldiv(p, m) + _kldiv(q, m))


def jensen_shannon_divergence(p, q) -> float:
    p, q = np.asarray(p, dtype=np.float64), np.asarray(q, dtype=np.float64)
    if np.any(p < 0) or np.any(q < 0):
        raise ValueError("Negative values.")
    if len(p) != len(q):
        raise ValueError("Non equal size.")
    p_ = p / np.sum(p)
    q_ = q / np.sum(q)
    e1, e2 = entropy(p_, base=2), entropy(q_, base=2)
    e_sum = entropy((p_ + q_) / 2.0, base=2)
    res = e_sum - (e1 + e2) / 2.0
    if not np.allclose(res, _jsdiv(p_, q_), atol=1e-4, rtol=0):
        warnings.warn("Numerical values of two JSD methods don't agree.")
    return float(res)


def jsd_between_point_cloud_sets(sample_pcs, ref_pcs=None, resolution: int = 28,
                                 ref_grid=None) -> float:
    """JSD between occupancy distributions; ``ref_grid`` skips recomputing the ref's grid."""
    sample_grid = entropy_of_occupancy_grid(sample_pcs, resolution, True)[1]
    if ref_grid is None:
        if ref_pcs is None:
            raise ValueError("need ref_pcs or ref_grid")
        ref_grid = entropy_of_occupancy_grid(ref_pcs, resolution, True)[1]
    return jensen_shannon_divergence(sample_grid, ref_grid)
