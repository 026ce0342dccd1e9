"""Empirical latent prior for the generative experiments.

Port of ``hyperpocket_tpu/eval/latent_stats.py``. ``fit_latent_gaussian``
encodes missing halves with the random (VAE) encoder, takes the posterior
means, and fits a full-covariance Gaussian to them (sample covariance
shrunk 5% toward its diagonal, plus a small jitter); experiments with
``noise_source="empirical"`` draw the missing-half code from it instead of
the isotropic ``N(mean, std)``. An opt-in extension of the JAX package; every
experiment defaults to the isotropic draw. Encoding runs on the card unless
``device`` names another (and raises without CUDA).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hyperpocket_tpu_torch.serving import resolve_device

__all__ = [
    "LatentGaussian",
    "collect_val_missing_halves",
    "encode_missing_mus",
    "fit_latent_gaussian",
    "load_latent_gaussian",
    "save_latent_gaussian",
]


@dataclass(frozen=True)
class LatentGaussian:
    """Full-covariance Gaussian over the missing-half latent code."""

    mean: np.ndarray        # (Z,)
    scale_tril: np.ndarray  # (Z, Z) lower Cholesky factor of the covariance

    @property
    def dim(self) -> int:
        return int(self.mean.shape[0])

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """(n, Z) draws ``mean + eps @ scale_tril.T`` on the generator's device."""
        device = generator.device
        eps = torch.randn((n, self.dim), generator=generator, device=device)
        return self.transform(eps)

    def transform(self, eps: torch.Tensor) -> torch.Tensor:
        """``mean + eps @ scale_tril.T`` for standard-normal ``eps`` (n, Z)."""
        mean = torch.as_tensor(self.mean, device=eps.device)
        tril = torch.as_tensor(self.scale_tril, device=eps.device)
        return mean + eps @ tril.T


def save_latent_gaussian(lg: LatentGaussian, path: str) -> None:
    """npz sidecar (mean + covariance Cholesky factor)."""
    np.savez(path, mean=lg.mean, scale_tril=lg.scale_tril)


def load_latent_gaussian(path: str) -> LatentGaussian:
    with np.load(path) as z:
        return LatentGaussian(mean=np.asarray(z["mean"], np.float32),
                              scale_tril=np.asarray(z["scale_tril"], np.float32))


def encode_missing_mus(model, clouds: np.ndarray, batch_size: int = 64,
                       device="cuda") -> np.ndarray:
    """Missing-half clouds (N, M, 3) -> posterior means (N, Z), ``batch_size`` at a time.

    The random encoder's inference forward (``fast=True``) on the fp32
    parameters, as in the JAX package; the sampled code is not used, so its
    noise is zero.
    """
    device = resolve_device(device)
    clouds = np.asarray(clouds, dtype=np.float32)
    encoder = model.random_encoder
    out = []
    with torch.no_grad():
        for start in range(0, clouds.shape[0], batch_size):
            block = torch.as_tensor(clouds[start:start + batch_size], device=device)
            eps = torch.zeros((block.shape[0], model.get_noise_size()), device=device)
            _, mu, _ = encoder(block, is_vae=True, fast=True, eps=eps)
            out.append(mu.float().cpu().numpy())
    return np.concatenate(out, axis=0)


def collect_val_missing_halves(val_dict, max_items: int = 1024) -> np.ndarray:
    """Up to ``max_items`` real missing halves from the val datasets, split evenly
    across categories; items with a scalar placeholder at index 1 are skipped.
    Raises ``ValueError`` when no item qualifies."""
    halves = []
    for ds in val_dict.values():
        take = min(len(ds), max(1, max_items // max(len(val_dict), 1)))
        halves.extend(np.asarray(ds[i][1], dtype=np.float32) for i in range(take))
    halves = [h for h in halves if h.ndim == 2]
    if not halves:
        raise ValueError(
            "latent prior: no val items with real missing halves to fit on "
            "(Completion3D has placeholders everywhere)")
    return np.stack(halves)


def fit_latent_gaussian(model, missing_clouds: np.ndarray, batch_size: int = 64,
                        shrinkage: float = 0.05, device="cuda") -> LatentGaussian:
    """Fit the empirical Gaussian of posterior means over ``missing_clouds``."""
    mus = encode_missing_mus(model, missing_clouds, batch_size, device)
    mean = mus.mean(axis=0)
    centered = mus - mean
    denom = max(mus.shape[0] - 1, 1)
    cov = centered.T @ centered / denom
    diag = np.diag(np.diag(cov))
    cov = (1.0 - shrinkage) * cov + shrinkage * diag
    # jitter keeps the Cholesky factor defined on rank-deficient tiny corpora
    cov += np.eye(cov.shape[0], dtype=cov.dtype) * (
        1e-6 * float(np.trace(cov)) / cov.shape[0] + 1e-12)
    scale_tril = np.linalg.cholesky(cov)
    return LatentGaussian(mean=mean.astype(np.float32), scale_tril=scale_tril.astype(np.float32))
