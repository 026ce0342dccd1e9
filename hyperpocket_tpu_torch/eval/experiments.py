"""Experiment registry (reference core/experiments.py:397-405).

Port of ``hyperpocket_tpu/eval/experiments.py``, with the same experiment
names, config keys and artifacts ((3, N) ``.npy`` clouds, json results):

* ``fixed``: noise-conditioned completions written to ``fixed/``;
* ``evaluate_generativity``: per-object MMD/COV over CD and EMD and JSD
  against the category's missing halves, summed per category;
* ``compute_mmd_tmd_uhd``: reads ``fixed/``; MMD*1000, UHD*100, TMD*100;
* ``merge_different_categories``, ``same_model_different_slices``,
  ``completion3d_submission``, ``temp_exp``.

Randomness follows the JAX package's counter schedule: ``ctx.next_key()``
hands out ``seed * 1_000_003 + 1, + 2, ...`` (as uint32), one per noise draw
and one per completion, in the same order. The draws for a counter value
come from ``ctx.draws``: by default a ``torch.Generator`` seeded with it
(``TorchDraws``), so a run is reproducible but does not give the JAX
package's numbers. A test injects the JAX package's own draws through the
same two methods: ``noise(seed, batch, mean, std, source)``, the latent
codes (the JAX context's ``_noise``/``_noise_prior``), and ``balls(seed,
batch, num_points, epoch)``, the target network's input points.

Not ported: ``make_tsne_reduction`` (not registered in the JAX package
either) and ``save_plots=True``; both raise ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import glob
import json
import logging
import os
import shutil
import time
from os.path import basename, join
from zipfile import ZipFile

import numpy as np
import torch

from hyperpocket_tpu_torch.data.loader import BatchLoader
from hyperpocket_tpu_torch.data.slicer import slice_point_cloud
from hyperpocket_tpu_torch.ops.sampling import generate_target_network_input_batch
from hyperpocket_tpu_torch.serving import resolve_device

log = logging.getLogger("hyperpocket_tpu_torch.experiments")


class TorchDraws:
    """The default draws: a ``torch.Generator`` on ``device`` seeded with the counter."""

    def __init__(self, model, device):
        self.model = model
        self.device = torch.device(device)

    def _generator(self, seed) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def noise(self, seed, batch: int, mean, std, source: str) -> torch.Tensor:
        """(batch, Z) missing-half codes from standard normals ``eps``.

        ``source="normal"``: ``mean + std * eps``; ``"empirical"``: ``mean + eps @
        std.T``, with the fitted prior's mean (Z,) and Cholesky factor (Z, Z).
        """
        eps = torch.randn((batch, self.model.get_noise_size()),
                          generator=self._generator(seed), device=self.device)
        if source == "empirical":
            return (torch.as_tensor(mean, device=self.device)
                    + eps @ torch.as_tensor(std, device=self.device).T)
        return mean + std * eps

    def balls(self, seed, batch: int, num_points: int, epoch: float) -> torch.Tensor:
        """(batch, num_points, 3) target-network input points at ``epoch``."""
        return generate_target_network_input_batch(
            self.model.target_network_input, self._generator(seed), epoch, batch, num_points,
            method=self.model.ball_method)


class ExperimentContext:
    """The restored model, its epoch and the draws handed to every experiment."""

    def __init__(self, model, epoch: int, seed: int = 2020, device="cuda", draws=None):
        self.model = model
        self.epoch = epoch
        self.seed = seed
        self.device = resolve_device(device)
        self.draws = draws if draws is not None else TorchDraws(model, self.device)
        self.latent_prior = None  # set by fit_latent_prior
        self._counter = int(seed) * 1_000_003
        # experiment-level sampling (object choice, re-slicing planes)
        self.np_rng = np.random.default_rng(seed)
        # wall seconds by part, added up over the run (see ``timed``)
        self.timings: dict[str, float] = {}

    def next_key(self) -> np.uint32:
        self._counter += 1
        return np.uint32(self._counter & 0xFFFFFFFF)

    @contextlib.contextmanager
    def timed(self, name: str):
        """Add the block's wall time, synchronised on a card, to ``timings[name]``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings[name] = self.timings.get(name, 0.0) + time.perf_counter() - t0

    def _noise_params(self, mean: float, std: float, source: str) -> tuple:
        """``draws.noise``'s (mean, std): the isotropic draw's, or for
        ``source="empirical"`` the fitted prior's mean and Cholesky factor."""
        if source == "empirical":
            if self.latent_prior is None:
                raise ValueError(
                    "noise_source='empirical' requires ctx.fit_latent_prior() "
                    "(or experiments.latent_prior in the config) first")
            return self.latent_prior.mean, self.latent_prior.scale_tril
        if source != "normal":
            raise ValueError(f"unknown noise source {source!r}")
        return float(mean), float(std)

    def _noise(self, seed, batch: int, params: tuple, source: str) -> torch.Tensor:
        noise = self.draws.noise(seed, batch, *params, source)
        return torch.as_tensor(noise, dtype=torch.float32, device=self.device)

    def _apply(self, existing, missing, noise, seed, num_points: int) -> torch.Tensor:
        batch = existing.shape[0]
        balls = self.draws.balls(seed, batch, num_points, float(self.epoch))
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        return self.model.apply(existing, missing, generator, float(self.epoch),
                                num_output_points=num_points, training=False, noise=noise,
                                ball_points=torch.as_tensor(balls, device=self.device))

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=self.device)

    def complete(self, existing, noise, num_points: int = 2048) -> np.ndarray:
        """existing (B, N, 3) + noise (B, Z) -> completions (B, num_points, 3)."""
        out = self._apply(self._tensor(existing), None, self._tensor(noise), self.next_key(),
                          num_points)
        return out.cpu().numpy()

    def complete_from_missing(self, existing, missing, num_points: int = 2048) -> np.ndarray:
        out = self._apply(self._tensor(existing), self._tensor(missing), None, self.next_key(),
                          num_points)
        return out.cpu().numpy()

    def sample_noise(self, batch: int, mean: float, std: float,
                     source: str = "normal") -> np.ndarray:
        """Missing-half code draw: isotropic ``N(mean, std)``, or the fitted prior
        for ``source="empirical"``."""
        params = self._noise_params(mean, std, source)
        return self._noise(self.next_key(), batch, params, source).cpu().numpy()

    def fit_latent_prior(self, missing_clouds, batch_size: int = 64) -> None:
        """Fit the empirical latent Gaussian over (N, M, 3) missing halves."""
        from hyperpocket_tpu_torch.eval.latent_stats import fit_latent_gaussian

        self.latent_prior = fit_latent_gaussian(self.model, missing_clouds, batch_size,
                                                device=self.device)


def _plots_not_ported(save_plots: bool) -> None:
    if save_plots:
        raise NotImplementedError(
            "save_plots=True needs the plotting helpers, not ported yet (ROADMAP.md, "
            "open items: 'plots')")


# ---------------------------------------------------------------------------


def fixed(ctx: ExperimentContext, datasets_dict, results_dir: str, epoch, amount=30,
          mean=0.0, std=0.015, noises_per_item=10, batch_size=8, save_plots=False,
          triangulation_config=None, num_points=2048, noise_source="normal"):
    """Reference core/experiments.py:23-60; artifacts are (3, N) npy files.

    ``triangulation_config`` and ``amount`` are accepted and ignored, as in
    the reference (its loop covers the whole dataset).
    """
    _plots_not_ported(save_plots)
    out_dir = join(results_dir, "fixed")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir, exist_ok=True)
    for cat_name, ds in datasets_dict.items():
        loader = BatchLoader(ds, batch_size, shuffle=False, num_workers=4)
        for i, (existing, _, _, _) in enumerate(loader.epoch(0)):
            for j in range(noises_per_item):
                noise = ctx.sample_noise(existing.shape[0], mean, std, source=noise_source)
                rec = ctx.complete(existing, noise, num_points=num_points)  # (B, P, 3)
                for k in range(rec.shape[0]):
                    np.save(join(out_dir, f"{cat_name}_{i * batch_size + k}_{j}_reconstruction"),
                            rec[k].T)
            for k in range(existing.shape[0]):
                np.save(join(out_dir, f"{cat_name}_{i * batch_size + k}_existing"),
                        existing[k].T)


def _generate_completion_sets(ctx: ExperimentContext, existing_objs, n_gen: int,
                              batch_size: int, mean: float, std: float,
                              dispatch_clouds: int = 512, num_points: int = 2048,
                              noise_source: str = "normal") -> np.ndarray:
    """n_gen completions per object -> (n_obj, n_gen, num_points, 3).

    The (object, block) schedule takes counter values in the order of the
    reference's per-object loop (core/experiments.py:81-93): a noise draw and
    a completion per block of ``batch_size``. Blocks of one size go through
    the model together, ``dispatch_clouds // block`` blocks per ``apply``.
    """
    n_obj = len(existing_objs)
    schedule = []  # (obj, start, block, noise_seed, ball_seed), in loop order
    for o in range(n_obj):
        for start in range(0, n_gen, batch_size):
            b = min(batch_size, n_gen - start)
            schedule.append((o, start, b, ctx.next_key(), ctx.next_key()))
    out = np.empty((n_obj, n_gen, num_points, 3), np.float32)
    epoch = float(ctx.epoch)
    params = ctx._noise_params(mean, std, noise_source)
    for block in sorted({e[2] for e in schedule}):
        entries = [e for e in schedule if e[2] == block]
        group = max(1, dispatch_clouds // block)
        for g0 in range(0, len(entries), group):
            chunk = entries[g0:g0 + group]
            ex = torch.cat([ctx._tensor(existing_objs[o])[None].expand(block, -1, -1)
                            for o, *_ in chunk])
            noise = torch.cat([ctx._noise(ns, block, params, noise_source)
                               for *_, ns, _ in chunk])
            balls = torch.cat([torch.as_tensor(ctx.draws.balls(bs, block, num_points, epoch),
                                               device=ctx.device) for *_, bs in chunk])
            rec = ctx.model.apply(ex, None, None, epoch, num_output_points=num_points,
                                  training=False, noise=noise, ball_points=balls)
            rec = rec.cpu().numpy().reshape(len(chunk), block, num_points, 3)
            for (o, start, b, _, _), r in zip(chunk, rec):
                out[o, start:start + b] = r
    return out


def _lowest_y_1024(recs: np.ndarray) -> np.ndarray:
    """Keep the 1024 lowest-y points of each cloud (experiments.py:92)."""
    order = np.argsort(recs[..., 1], axis=-1)[..., :1024]
    return np.take_along_axis(recs, order[..., None], axis=-2)


def evaluate_generativity(ctx: ExperimentContext, datasets_dict, results_dir: str, epoch,
                          batch_size=25, num_workers=8, mean=0.0, std=0.005,
                          dispatch_clouds=512, object_group_clouds=8192,
                          noise_source="normal", include_1nna=False, parallel_data=None):
    """Reference core/experiments.py:63-104: per-object MMD/COV + JSD against the
    category's missing halves, summed over the category's objects (the
    reference's quirk, kept).

    Each object gets ``len(category)`` completions, cut to their 1024 lowest-y
    points; the per-object CD and EMD matrices come from
    ``pairwise_emd_cd_multi``'s flat pair dispatches, ``dispatch_clouds``
    pairs each. ``object_group_clouds`` bounds the completions held at once.
    ``num_workers`` is accepted for the config schema and unused.
    ``include_1nna`` adds the 1-NN accuracies the reference computes but
    leaves out. ``parallel_data`` > 1 (sharding the matrix builds over
    devices) is not ported.
    """
    from hyperpocket_tpu_torch.eval.metrics import (
        entropy_of_occupancy_grid,
        jsd_between_point_cloud_sets,
        knn_batch_1nna,
        mmd_cov_multi,
        pairwise_emd_cd,
        pairwise_emd_cd_multi,
    )

    if parallel_data and int(parallel_data) > 1:
        raise NotImplementedError(
            "parallel_data > 1 shards the matrix builds over devices, which comes with the "
            "parallelism slice (ROADMAP.md, open items: 'parallel_data')")
    os.makedirs(join(results_dir, "evaluate_generativity"), exist_ok=True)
    results: dict[str, dict] = {}
    for cat_name, ds in datasets_dict.items():
        if len(ds) == 0:
            raise ValueError(
                f"evaluate_generativity got an empty dataset for category "
                f"{cat_name!r} (split matched no on-disk models?)")
        with ctx.timed("load_s"):
            items = [ds[i] for i in range(len(ds))]
        if np.ndim(items[0][1]) != 2:
            raise ValueError(
                f"evaluate_generativity needs items with a real missing-part "
                f"cloud at index 1; category {cat_name!r} has a scalar "
                "placeholder. For 3D-EPN that is the test split (val has "
                "real missing halves); Completion3D has the placeholder on "
                "every split, so disable this experiment there, as the "
                "reference configs do")
        cat_gt = np.stack([np.asarray(it[1], dtype=np.float32) for it in items])
        n_gen = len(cat_gt)
        existing_objs = [np.asarray(it[0], dtype=np.float32) for it in items]
        del items
        with ctx.timed("jsd_s"):
            ref_grid = entropy_of_occupancy_grid(cat_gt, 28, True)[1]
        cat_results: dict[str, float] = {}
        group = max(1, object_group_clouds // max(n_gen, 1))
        if include_1nna:
            m_rr_cd, m_rr_emd = pairwise_emd_cd(cat_gt, cat_gt, batch_size, device=ctx.device)
        for o0 in range(0, len(ds), group):
            objs = existing_objs[o0:o0 + group]
            with ctx.timed("completion_s"):
                recs = _generate_completion_sets(ctx, objs, n_gen, batch_size, mean, std,
                                                 dispatch_clouds, noise_source=noise_source)
                recs = _lowest_y_1024(recs)
            with ctx.timed("matrices_s"):  # of which cd_s and emd_s in the pair ops
                m_rs_cd, m_rs_emd = pairwise_emd_cd_multi(cat_gt, recs, dispatch_clouds,
                                                          device=ctx.device, timings=ctx.timings)
                per_object = mmd_cov_multi(m_rs_cd, m_rs_emd)
            if include_1nna:
                m_ss_cd, m_ss_emd = pairwise_emd_cd_multi(recs, recs, dispatch_clouds,
                                                          device=ctx.device)
                for tag, m_rr, m_rs, m_ss in (("CD", m_rr_cd, m_rs_cd, m_ss_cd),
                                              ("EMD", m_rr_emd, m_rs_emd, m_ss_emd)):
                    res = knn_batch_1nna(m_rr.cpu(), torch.as_tensor(m_rs),
                                         torch.as_tensor(m_ss))
                    for k, v in res.items():
                        if "acc" in k:
                            for g, obj_res in enumerate(per_object):
                                obj_res[f"1-NN-{tag}-{k}"] = float(v[g])
            with ctx.timed("jsd_s"):
                for obj_recs, obj_res in zip(recs, per_object):
                    for k, v in obj_res.items():
                        cat_results[k] = cat_results.get(k, 0.0) + float(v)
                    cat_results["jsd"] = cat_results.get("jsd", 0.0) + \
                        jsd_between_point_cloud_sets(obj_recs, ref_grid=ref_grid)
        results[cat_name] = cat_results
        log.info("%s %s", cat_name, cat_results)

    with open(join(results_dir, "evaluate_generativity", f"{epoch}eval_gen_by_cat.json"),
              "w") as fh:
        json.dump(results, fh)
    return results


def compute_mmd_tmd_uhd(ctx: ExperimentContext, datasets_dict, results_dir: str, epoch,
                        batch_size=64):
    """Reference core/experiments.py:107-128; reads the fixed/ directory."""
    from hyperpocket_tpu_torch.eval.evaluation import mmd_process, tmd_process, uhd_process

    os.makedirs(join(results_dir, "compute_mmd_tmd_uhd"), exist_ok=True)
    shape_dir = join(results_dir, "fixed")
    if not glob.glob(join(shape_dir, "*reconstruction.npy")):
        raise FileNotFoundError(
            f"compute_mmd_tmd_uhd found no *reconstruction.npy under {shape_dir}; "
            "the 'fixed' experiment must run first (list it before "
            "compute_mmd_tmd_uhd in experiments.settings)")
    if isinstance(datasets_dict, dict):
        if len(datasets_dict) != 1:
            # fixed/ holds every category in one directory; mmd_process
            # compares it with one dataset's gt
            raise ValueError(
                "compute_mmd_tmd_uhd requires a single-category test set; got "
                f"{sorted(datasets_dict)} — use a per-class config")
        dataset = next(iter(datasets_dict.values()))
    else:
        dataset = datasets_dict
    res = {}
    with ctx.timed("mmd_s"):
        mmd_v = mmd_process(shape_dir, dataset, batch_size, device=ctx.device)
    log.info("MMD * 1000 = %s", mmd_v * 1000)
    res["MMD * 1000"] = mmd_v * 1000
    with ctx.timed("uhd_s"):
        uhd_v = uhd_process(shape_dir, device=ctx.device)
    log.info("UHD * 100 = %s", uhd_v * 100)
    res["UHD * 100"] = uhd_v * 100
    with ctx.timed("tmd_s"):
        tmd_v = tmd_process(shape_dir, device=ctx.device)
    log.info("TMD * 100 = %s", tmd_v * 100)
    res["TMD * 100"] = tmd_v * 100
    with open(join(results_dir, "compute_mmd_tmd_uhd", f"{epoch}res.json"), "w") as fh:
        json.dump(res, fh)
    return res


def merge_different_categories(ctx: ExperimentContext, datasets_dict, results_dir: str, epoch,
                               amount=10, first_cat="car", second_cat="airplane",
                               split_points=1024):
    """Reference core/experiments.py:131-191: cross-category pocket transplants.

    As in the JAX package, the second category's ids are drawn from its own
    length and the second~second completion uses the second category's
    missing half (two reference bugs fixed, PARITY.md).
    """
    out_dir = join(results_dir, "merge_different_categories")
    os.makedirs(out_dir, exist_ok=True)
    first_ds, second_ds = datasets_dict[first_cat], datasets_dict[second_cat]
    if len(first_ds) < amount or len(second_ds) < amount:
        raise ValueError(
            f"with current dataset config the max amount value is "
            f"{min(len(first_ds), len(second_ds))}")
    first_ids = ctx.np_rng.choice(len(first_ds), amount, replace=False)
    second_ids = ctx.np_rng.choice(len(second_ds), amount, replace=False)

    def halves(gt):
        # x-sorted split at split_points -> (existing, missing)
        order = np.argsort(gt.T[0])
        return gt[order[split_points:]], gt[order[:split_points]]

    for i in range(amount):
        f_gt = np.asarray(first_ds[first_ids[i]][2], dtype=np.float32)
        s_gt = np.asarray(second_ds[second_ids[i]][2], dtype=np.float32)
        f_existing, f_missing = halves(f_gt)
        s_existing, s_missing = halves(s_gt)
        for tag, arrs in ((first_cat, (f_existing, f_missing, f_gt)),
                          (second_cat, (s_existing, s_missing, s_gt))):
            for name, arr in zip(("existing", "missing", "gt"), arrs):
                np.save(join(out_dir, f"{tag}_{i}_{name}"), arr)

        for j in range(amount):
            t_f_missing = halves(np.asarray(first_ds[first_ids[j]][2], dtype=np.float32))[1]
            t_s_missing = halves(np.asarray(second_ds[second_ids[j]][2], dtype=np.float32))[1]
            # each completion at its existing object's gt size; artifacts in
            # the reference's merge layout, (N, 3)
            pairs = (
                (f"{first_cat}_{i}~{first_cat}_{j}_rec", f_existing, t_f_missing, f_gt),
                (f"{first_cat}_{i}~{second_cat}_{j}_rec", f_existing, t_s_missing, f_gt),
                (f"{second_cat}_{i}~{first_cat}_{j}_rec", s_existing, t_f_missing, s_gt),
                (f"{second_cat}_{i}~{second_cat}_{j}_rec", s_existing, t_s_missing, s_gt),
            )
            for name, ex, mi, gt in pairs:
                rec = ctx.complete_from_missing(ex[None], mi[None], num_points=gt.shape[0])
                np.save(join(out_dir, name), rec[0])


def same_model_different_slices(ctx: ExperimentContext, datasets_dict, results_dir: str, epoch,
                                amount=10, slices_number=10, mean=0.0, std=0.015,
                                slice_points=1024):
    """Reference core/experiments.py:194-225: complete both halves of random re-slices."""
    out_dir = join(results_dir, "same_model_different_slices")
    os.makedirs(out_dir, exist_ok=True)

    def process_half(pcd, cat_name, tag, i, j):
        np.save(join(out_dir, f"{cat_name}_{i}_{j}_{tag}_pcd"), pcd)
        noise = ctx.sample_noise(1, mean, std)
        np.save(join(out_dir, f"{cat_name}_{i}_{j}_{tag}_noise"), noise)
        rec = ctx.complete(pcd[None].astype(np.float32), noise)[0]
        np.save(join(out_dir, f"{cat_name}_{i}_{j}_{tag}_rec"), rec.T)

    for cat_name, ds in datasets_dict.items():
        ids = ctx.np_rng.choice(len(ds), min(amount, len(ds)), replace=False)
        for i, idx in enumerate(ids):
            gt = np.asarray(ds[idx][2], dtype=np.float32)
            np.save(join(out_dir, f"{cat_name}_{i}_gt"), gt)
            for j in range(slices_number):
                first, second = slice_point_cloud(gt, slice_points, rng=ctx.np_rng)
                process_half(first, cat_name, "f", i, j)
                process_half(second, cat_name, "s", i, j)


def completion3d_submission(ctx: ExperimentContext, datasets_dict, results_dir: str, epoch,
                            batch_size=1):
    """Reference core/experiments.py:228-247: per-model h5 files + submission.zip."""
    import h5py

    bench_dir = join(results_dir, "completion3d_submission")
    shutil.rmtree(bench_dir, ignore_errors=True)
    os.makedirs(bench_dir, exist_ok=True)
    loader = BatchLoader(datasets_dict["all"], batch_size, shuffle=False, num_workers=4)
    with ZipFile(join(results_dir, "submission.zip"), "w") as zf:
        for existing, _, _, model_ids in loader.epoch(0):
            noise = ctx.sample_noise(existing.shape[0], 0.0, 0.0)
            rec = ctx.complete(existing, noise)  # (B, 2048, 3)
            for idx in range(rec.shape[0]):
                ofile = join(bench_dir, str(model_ids[idx]).split("/")[-1] + ".h5")
                with h5py.File(ofile, "w") as fh:
                    fh.create_dataset("data", data=rec[idx])
                zf.write(ofile, "all/" + basename(ofile))


def make_tsne_reduction(ctx: ExperimentContext, datasets_dict, results_dir: str, epoch,
                        cat_name: str | None = None, amount: int = 100):
    """t-SNE of latents and target-network weights; not ported (unregistered, as in JAX)."""
    raise NotImplementedError(
        "make_tsne_reduction needs scikit-learn's t-SNE and the encoder's latent/weight "
        "taps, not ported yet (ROADMAP.md, open items: 't-SNE')")


def temp_exp(ctx: ExperimentContext, datasets_dict, results_dir: str, epoch):
    """User extension stub (reference core/experiments.py:392-394)."""


experiment_functions_dict = {
    "fixed": fixed,
    "evaluate_generativity": evaluate_generativity,
    "compute_mmd_tmd_uhd": compute_mmd_tmd_uhd,
    "merge_different_categories": merge_different_categories,
    "same_model_different_slices": same_model_different_slices,
    "completion3d_submission": completion3d_submission,
    "temp_exp": temp_exp,
}


# ---------------------------------------------------------------------------


def run_experiments(config: dict, result_dir: str, datasets=None, device="cuda",
                    draws=None) -> ExperimentContext:
    """Experiments mode (reference core/main.py:176-188); returns the context.

    Restores the checkpoint the config names onto ``device``, builds the test
    datasets (or takes ``datasets``), fits the latent prior when
    ``experiments.latent_prior`` is set, and runs every experiment whose
    ``execute`` is true, in the config's order. ``draws`` replaces the
    context's default draws (see the module docstring).
    """
    from hyperpocket_tpu_torch.data.base import get_datasets
    from hyperpocket_tpu_torch.train.checkpoint import restore_trained_model
    from hyperpocket_tpu_torch.utils.logging_setup import seed_setup

    device = resolve_device(device)
    seed_setup(config["setup"]["seed"])
    model, epoch = restore_trained_model(config, device=device)
    model.eval()
    log.info("restored epoch %d for experiments", epoch)
    if datasets is None:
        _, _, test_dataset_dict = get_datasets(config["dataset"])
    else:
        test_dataset_dict = datasets
    ctx = ExperimentContext(model, epoch, seed=config["setup"]["seed"], device=device,
                            draws=draws)

    prior_cfg = config["experiments"].get("latent_prior")
    if prior_cfg:
        from hyperpocket_tpu_torch.eval.latent_stats import collect_val_missing_halves

        _, val_dict, _ = get_datasets(config["dataset"])
        halves = collect_val_missing_halves(val_dict, int(prior_cfg.get("max_items", 1024)))
        ctx.fit_latent_prior(halves, int(prior_cfg.get("batch_size", 64)))
        log.info("fitted empirical latent prior on %d missing halves", len(halves))

    for name, ex_cfg in config["experiments"]["settings"].items():
        ex_cfg = dict(ex_cfg)
        if ex_cfg.pop("execute", False):
            log.info("experiment: %s", name)
            os.makedirs(join(result_dir, name), exist_ok=True)
            with ctx.timed(f"{name}_s"):
                experiment_functions_dict[name](ctx, test_dataset_dict, result_dir, epoch,
                                                **ex_cfg)
    return ctx
