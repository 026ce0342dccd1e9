"""The completion model in plain PyTorch.

Follows the published HyperPocket / HyperRec model (arXiv:2102.05973) as
the settings schema configures it: PointNet encoders (pointwise layers
3-64-128-256-512-512 with ReLU between, a max over points, FC 512 + ReLU,
the ``mu`` head and, for the VAE encoder, a log-sigma head), a hypernetwork
(Z-64-128-512-1024-2048 with ReLU between, then one head for every target
layer's weight and bias, row-major (out, in) then bias, in layer order) and
the target network (3-32-64-128-64-3, ReLU between) run on points drawn in
the unit ball. The parameters are a dict in the state-dict naming of the
model (``real_encoder.conv.0.weight``, ...), each weight (out, in).

Every matrix product goes through ``Matmul`` with a quantizer ``q``: None
is fp32 with TF32 off, the reference itself; ``quant.tf32`` or
``quant.fp8`` round both operands of every product, forward and backward,
and make the lower-precision controls.
"""

from __future__ import annotations

import contextlib
import math

import torch

ENCODER_LAYERS = 5
HYPER_LAYERS = 5


@contextlib.contextmanager
def fp32_highest():
    """fp32 products with TF32 off, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


class _QMatmul(torch.autograd.Function):
    """``a @ b`` over the last two dims with both operands rounded by ``q``,
    and the two products of the backward rounded alike."""

    @staticmethod
    def forward(ctx, a, b, q):
        qa, qb = q(a), q(b)
        ctx.save_for_backward(qa, qb)
        ctx.q = q
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = ctx.q(g)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.transpose(-1, -2) @ qg
        # a weight shared over a batch of rows: sum the broadcast dims away
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        while ga.dim() > qa.dim():
            ga = ga.sum(0)
        return ga, gb, None


def matmul(a: torch.Tensor, b: torch.Tensor, q=None) -> torch.Tensor:
    return a @ b if q is None else _QMatmul.apply(a, b, q)


def linear(x, w, b, q=None):
    """``x @ w.T + b`` with ``w`` (out, in)."""
    y = matmul(x, w.t(), q)
    return y if b is None else y + b


def encoder(p: dict, prefix: str, x: torch.Tensor, q=None):
    """(mu, raw_std) of the encoder ``prefix`` on clouds x (B, N, 3);
    raw_std is None where the parameters hold no ``std`` head."""
    h = x
    for i in range(ENCODER_LAYERS):
        h = linear(h, p[f"{prefix}.conv.{i}.weight"], p[f"{prefix}.conv.{i}.bias"], q)
        if i < ENCODER_LAYERS - 1:
            h = torch.relu(h)
    pooled = h.amax(dim=1)
    f = torch.relu(linear(pooled, p[f"{prefix}.fc.weight"], p[f"{prefix}.fc.bias"], q))
    mu = linear(f, p[f"{prefix}.mu.weight"], p[f"{prefix}.mu.bias"], q)
    raw_std = linear(f, p[f"{prefix}.std.weight"], p[f"{prefix}.std.bias"], q)
    return mu, raw_std


def hyper_network(p: dict, latent: torch.Tensor, q=None) -> torch.Tensor:
    """latent (B, Z) -> the flat target-network weights (B, W)."""
    h = latent
    for i in range(HYPER_LAYERS):
        h = linear(h, p[f"hyper_network.trunk.{i}.weight"], p[f"hyper_network.trunk.{i}.bias"], q)
        if i < HYPER_LAYERS - 1:
            h = torch.relu(h)
    return linear(h, p["hyper_network.heads.weight"], p["hyper_network.heads.bias"], q)


def decode(flat: torch.Tensor, points: torch.Tensor, layer_out_channels, q=None):
    """The target network of each cloud on its points: (B, W) x (B, N, 3) -> (B, N, 3)."""
    ch = [3, *layer_out_channels, 3]
    batch, off, x = flat.shape[0], 0, points
    for i in range(1, len(ch)):
        n_in, n_out = ch[i - 1], ch[i]
        w = flat[:, off:off + n_in * n_out].reshape(batch, n_out, n_in)
        off += n_in * n_out
        b = flat[:, off:off + n_out]
        off += n_out
        x = matmul(x, w.transpose(1, 2), q) + b[:, None, :]
        if i < len(ch) - 1:
            x = torch.relu(x)
    if off != flat.shape[1]:
        raise ValueError(f"flat weights of {flat.shape[1]} values, the decoder takes {off}")
    return x


def ball_points(generator: torch.Generator, batch: int, n: int, epoch: float,
                tni: dict) -> torch.Tensor:
    """The target network's input: ``n`` points uniform in the unit ball a
    cloud (a normal direction scaled by ``u ** (1/3)``: the "exact" method),
    then, under a progressive normalization of ``E`` epochs, the points with
    a norm below ``coef = (epoch - 1) / (E - 1)`` (1 past E) pushed onto the
    sphere of radius coef."""
    dev = generator.device
    direction = torch.randn((batch, n, 3), generator=generator, device=dev)
    direction = direction / direction.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    radius = torch.rand((batch, n, 1), generator=generator, device=dev) ** (1.0 / 3)
    pts = direction * radius
    norm_cfg = tni.get("normalization", {})
    if norm_cfg.get("enable") and norm_cfg.get("type") == "progressive":
        total = int(norm_cfg["epoch"])
        e = torch.full((), float(epoch), device=dev)
        coef = torch.where(e <= total, (e - 1.0) / max(total - 1, 1), torch.ones_like(e))
        norms = pts.norm(dim=-1, keepdim=True)
        pts = torch.where(norms < coef, coef * pts / norms.clamp_min(1e-12), pts)
    return pts


def complete(p: dict, model: dict, existing: torch.Tensor, noise: torch.Tensor | None,
             balls: torch.Tensor, q=None) -> torch.Tensor:
    """The inference forward with the latent noise given: (B, N_out, 3)."""
    real_mu, _ = encoder(p, "real_encoder", existing, q)
    latent = real_mu if int(model["random_encoder"]["output_size"]) <= 0 else torch.cat(
        [noise, real_mu], dim=1)
    flat = hyper_network(p, latent, q)
    return decode(flat, balls, model["target_network"]["layer_out_channels"], q)


def nearest(a: torch.Tensor, b: torch.Tensor, block: int = 256) -> torch.Tensor:
    """For each point of ``a`` (B, N, 3) the index of its nearest point of
    ``b`` (B, M, 3), from the exact squared differences, in blocks of rows."""
    out = []
    with torch.no_grad():
        for s in range(0, a.shape[1], block):
            d = (a[:, s:s + block, None, :] - b[:, None, :, :]).square().sum(-1)
            out.append(d.argmin(dim=2))
    return torch.cat(out, dim=1)


def chamfer_sum(gt: torch.Tensor, rec: torch.Tensor, q=None) -> torch.Tensor:
    """The sum over clouds and points of the squared distance to the nearest
    point of the other cloud, both ways. In fp32 each distance is the
    squared difference to the nearest point (the gradient flows through
    it); with ``q`` the distances are ``|x|^2 + |y|^2 - 2 x.y`` with the
    product rounded, as a lower-precision GEMM computes them."""
    if q is not None:
        d = ((gt * gt).sum(-1)[:, :, None] + (rec * rec).sum(-1)[:, None, :]
             - 2.0 * matmul(gt, rec.transpose(1, 2), q))
        return d.amin(dim=2).sum() + d.amin(dim=1).sum()

    def pick(cloud, idx):
        return torch.gather(cloud, 1, idx[..., None].expand(-1, -1, 3))

    return ((gt - pick(rec, nearest(gt, rec))).square().sum()
            + (rec - pick(gt, nearest(rec, gt))).square().sum())


def train_loss(p: dict, model: dict, existing, missing, gt, vae_eps, balls, loss_coef: float,
               q=None, rows: slice | None = None):
    """(loss, loss_r, loss_k) of a HyperPocket or HyperRec train step: the
    training forward (the VAE's sample ``eps * exp(raw_std) + mu`` on the
    missing half), ``loss_coef`` times the Chamfer sum, and the reference's
    KLD on sigma = exp(raw_std): ``0.5 * sum(exp(sigma) + mu^2 - 1 - sigma) / B``.

    ``rows`` keeps only those rows of the batch and scales the sums back
    to the whole batch: the fault "half of the batch left out, the mean
    taken over the rest"."""
    batch = existing.shape[0]
    if rows is not None:
        existing, gt, balls = existing[rows], gt[rows], balls[rows]
        missing = None if missing is None else missing[rows]
        vae_eps = None if vae_eps is None else vae_eps[rows]
    scale = batch / existing.shape[0]
    real_mu, _ = encoder(p, "real_encoder", existing, q)
    rand = int(model["random_encoder"]["output_size"])
    if rand > 0:
        mu, raw_std = encoder(p, "random_encoder", missing, q)
        z = vae_eps * torch.exp(raw_std) + mu
        latent = torch.cat([z, real_mu], dim=1)
    else:
        latent = real_mu
    rec = decode(hyper_network(p, latent, q), balls, model["target_network"]["layer_out_channels"],
                 q)
    loss_r = loss_coef * chamfer_sum(gt, rec, q) * scale
    if rand > 0:
        sigma = torch.exp(raw_std)
        loss_k = 0.5 * torch.sum(torch.exp(sigma) + mu * mu - 1.0 - sigma) * scale / batch
    else:
        loss_k = torch.zeros((), device=existing.device)
    return loss_r + loss_k, loss_r, loss_k


def val_loss(p: dict, model: dict, existing, missing, gt, balls, loss_coef: float, q=None,
             rows: slice | None = None):
    """A val step's loss: the inference forward (the VAE encoder's mu on the
    missing half as the latent noise; HyperRec none) and ``loss_coef`` times
    the Chamfer sum. ``rows`` as in ``train_loss``."""
    batch = existing.shape[0]
    if rows is not None:
        existing, missing, gt, balls = existing[rows], missing[rows], gt[rows], balls[rows]
    noise = (encoder(p, "random_encoder", missing, q)[0]
             if int(model["random_encoder"]["output_size"]) > 0 else None)
    rec = complete(p, model, existing, noise, balls, q)
    return loss_coef * chamfer_sum(gt, rec, q) * batch / existing.shape[0]


class Adam:
    """Adam as the configs state it (``optimizer.type: Adam``, weight decay 0):
    ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, and
    ``p -= lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``.
    ``state`` = (m, v, t) resumes from those moments after ``t`` steps."""

    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 state=None):
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        if state is None:
            state = ({k: torch.zeros_like(v) for k, v in params.items()},
                     {k: torch.zeros_like(v) for k, v in params.items()}, 0)
        self.m, self.v, self.t = state

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            params[k] -= self.lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps)


def xavier_relu_bound(fan_in: int, fan_out: int) -> float:
    return math.sqrt(2.0) * math.sqrt(6.0 / (fan_in + fan_out))
