"""Uniform-ball point sampling for the target-network input.

Port of ``hyperpocket_tpu/ops/sampling.py``: ``"exact"`` draws radius
``u^(1/3)`` times a uniform direction; ``"rejection"`` draws 3x as many points
in [-1, 1]^3 and keeps the first N inside the ball, in draw order.
``progressive_normalize`` pushes points with norm below
``coef = linspace(0, 1, max_epoch)[epoch - 1]`` (1 past the schedule) onto the
sphere of radius ``coef``.

Every draw takes an explicit ``torch.Generator``; the tensors land on the
generator's device. The numbers differ from JAX's for the same seed.
"""

from __future__ import annotations

import torch


def sample_uniform_ball_batch(generator: torch.Generator, batch: int, num_points: int, *,
                              method: str = "exact") -> torch.Tensor:
    """(batch, num_points, 3) fp32 points, uniform in the open unit ball."""
    device = generator.device
    if method == "exact":
        direction = torch.randn((batch, num_points, 3), generator=generator, device=device)
        direction = direction / direction.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        radius = torch.rand((batch, num_points, 1), generator=generator,
                            device=device) ** (1.0 / 3.0)
        return direction * radius
    if method == "rejection":
        pts = torch.rand((batch, 3 * num_points, 3), generator=generator, device=device) * 2 - 1
        outside = (pts.norm(dim=-1) >= 1.0).to(torch.uint8)
        # stable sort on the out-of-ball flag keeps in-ball points in draw order
        order = torch.argsort(outside, dim=1, stable=True)[:, :num_points]
        return torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))
    raise ValueError(f"unknown ball-sampling method: {method!r}")


def progressive_normalize(points: torch.Tensor, epoch, max_epoch: int) -> torch.Tensor:
    """Push points with norm < coef onto the sphere of radius coef."""
    # a fill, not a copy from the host: a copy from pageable memory would
    # wait for the card's queue at every draw
    epoch = (epoch.to(device=points.device, dtype=points.dtype)
             if isinstance(epoch, torch.Tensor)
             else torch.full((), float(epoch), dtype=points.dtype, device=points.device))
    denom = max(max_epoch - 1, 1)
    coef = torch.where(epoch <= max_epoch, (epoch - 1.0) / denom, torch.ones_like(epoch))
    norms = points.norm(dim=-1, keepdim=True)
    pushed = coef * points / norms.clamp_min(1e-12)
    return torch.where(norms < coef, pushed, points)


def generate_target_network_input_batch(config: dict, generator: torch.Generator, epoch,
                                        batch: int, num_points: int, *,
                                        method: str = "exact") -> torch.Tensor:
    """Config-driven sampler -> (batch, num_points, 3).

    ``config`` is the model's ``target_network_input`` section. At the
    serving default ``epoch=1e9`` a progressive schedule has ended: coef is
    1 and every point is pushed onto the unit sphere.
    """
    pts = sample_uniform_ball_batch(generator, batch, num_points, method=method)
    norm_cfg = config.get("normalization", {})
    if norm_cfg.get("enable") and norm_cfg.get("type") == "progressive":
        pts = progressive_normalize(pts, epoch, int(norm_cfg["epoch"]))
    return pts
