"""Random-plane point-cloud slicer (the "pocket" generator).

The host part of ``hyperpocket_tpu/data/slicer.py`` (numpy); its jittable
device slicer is JAX-only and not ported.

Reproduces reference ``datasets/utils/dataset_generator.py:4-39``: draw a
plane through three uniform [0,1)^3 points, repeat until exactly
``target_partition_points`` points fall on one side; return (existing,
missing) with the exact-size side first. Host-side numpy.
"""

from __future__ import annotations

import numpy as np


class HyperPlane:
    def __init__(self, params: np.ndarray, bias: float):
        self.params = params
        self.bias = bias

    def check_point(self, points: np.ndarray) -> np.ndarray:
        return np.sign(points @ self.params + self.bias)

    @staticmethod
    def from_3_points(points: np.ndarray) -> "HyperPlane":
        normal = np.cross(points[1] - points[0], points[2] - points[0])
        return HyperPlane(normal, np.dot(normal, points[0]))

    @staticmethod
    def random(rng: np.random.Generator | None = None) -> "HyperPlane":
        draw = rng.random((3, 3)) if rng is not None else np.random.rand(3, 3)
        return HyperPlane.from_3_points(draw)

    def __repr__(self):
        return f"HyperPlane(A={self.params[0]}, B={self.params[1]}, C={self.params[2]}, D={self.bias})"


def slice_point_cloud(
    points: np.ndarray,
    target_partition_points: int = 1024,
    rng: np.random.Generator | None = None,
    max_tries: int = 100_000,
) -> tuple[np.ndarray, np.ndarray]:
    """Rejection-sample planes until one side has exactly the target count.

    Note the reference's acceptance test is on *bias* ``> 0`` vs ``not > 0``;
    sign(0) points land on the "above" side, matching
    dataset_generator.py:31-39.
    """
    for _ in range(max_tries):
        under = HyperPlane.random(rng).check_point(points) > 0
        n_under = int(under.sum())
        if n_under == target_partition_points:
            return points[under], points[~under]
        if len(points) - n_under == target_partition_points:
            return points[~under], points[under]
    raise RuntimeError(
        f"no plane produced an exact {target_partition_points}-point side in {max_tries} tries"
    )
