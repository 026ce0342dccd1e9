"""Point-cloud augmentation helpers (reference utils/pcutil.py:10-106).

A copy of ``hyperpocket_tpu/utils/augment.py`` (numpy only).

``rand_rotation_matrix`` implements the Arvo trick (Graphics Gems III):
uniform random rotations via a Householder reflection of a random Z-rotation,
with a ``deflection`` knob for small perturbations.
"""

from __future__ import annotations

import numpy as np


def rand_rotation_matrix(deflection: float = 1.0, seed=None, rng: np.random.Generator | None = None) -> np.ndarray:
    if seed is not None:
        np.random.seed(seed)
    draw = rng.uniform(size=(3,)) if rng is not None else np.random.uniform(size=(3,))
    theta, phi, z = draw
    theta = theta * 2.0 * deflection * np.pi  # rotation about the pole (Z)
    phi = phi * 2.0 * np.pi  # direction of pole deflection
    z = z * 2.0 * deflection  # magnitude of pole deflection

    r = np.sqrt(z)
    v = np.array([np.sin(phi) * r, np.cos(phi) * r, np.sqrt(2.0 - z)])
    st, ct = np.sin(theta), np.cos(theta)
    rot_z = np.array(((ct, st, 0), (-st, ct, 0), (0, 0, 1)))
    return (np.outer(v, v) - np.eye(3)).dot(rot_z)


def add_gaussian_noise_to_pcloud(pcloud: np.ndarray, mu: float = 0, sigma: float = 1) -> np.ndarray:
    """Per-point scalar noise tiled across xyz (pcutil.py:51-56 semantics)."""
    gnoise = np.random.normal(mu, sigma, pcloud.shape[0])
    return pcloud + np.tile(gnoise, (3, 1)).T


def add_rotation_to_pcloud(pcloud: np.ndarray) -> np.ndarray:
    rotation = rand_rotation_matrix()
    if pcloud.ndim == 2:
        return pcloud.dot(rotation)
    return np.asarray([cloud.dot(rotation) for cloud in pcloud])


def apply_augmentations(batch: np.ndarray, conf) -> np.ndarray:
    """Gaussian jitter + z-only random rotation, per reference pcutil.py:68-84."""
    if getattr(conf, "gauss_augment", None) is not None or getattr(conf, "z_rotate", False):
        batch = batch.copy()
    if getattr(conf, "gauss_augment", None) is not None:
        mu, sigma = conf.gauss_augment["mu"], conf.gauss_augment["sigma"]
        batch = batch + np.random.normal(mu, sigma, batch.shape)
    if getattr(conf, "z_rotate", False):
        rotation = rand_rotation_matrix()
        rotation[0, 2] = rotation[2, 0] = rotation[1, 2] = rotation[2, 1] = 0
        rotation[2, 2] = 1
        batch = batch.dot(rotation)
    return batch
