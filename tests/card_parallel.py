"""The parallel layer over NCCL on several cards, held to one process on rank 0.

Run on a machine with 4 cards, from the repository root::

    torchrun --nproc-per-node 4 tests/card_parallel.py

Checks, each fatal (rank 0 prints one JSON line of results at the end):

* the ring (``parallel/point_sharding.py``) over all ranks and over rank
  pairs, fp32, B=8 at 2048x2048 and 1024x2048: distances and indices
  equal to ``ops.nn.nn_forward`` on the whole clouds, the Chamfer value
  within 1e-5 and its gradient within 1e-5 of ``nn_backward`` on those
  indices;
* ``pairwise_emd_cd_multi(mesh=)`` over all ranks on 2 x 16 x 16 pairs at
  1024 points: every pair equal to rank 0's unsharded call;
* bf16 serving of the full-width chair model at B=256 over all ranks
  (``make_serving_fn(mesh=)``) within 2e-2 of scale (K4's bound) of rank
  0's one-process output, and the ranks' outputs equal;
* two fp32 train steps of the full-width chair model at B=8 on a
  (world/2, 2) data x tensor-parallel mesh against rank 0's one-process
  steps (deterministic algorithms): step-0 loss within 1e-5, step-1 within
  1e-3 (Adam's first update is lr * sign(g)), the gathered parameters
  of the one-process shapes.
"""

from __future__ import annotations

import copy
import json
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def points(b: int, n: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((b, n, 3), generator=g, device=device) * 0.3


def ring(device) -> dict:
    from hyperpocket_tpu_torch.ops.chamfer import nn_backward
    from hyperpocket_tpu_torch.ops.nn import nn_forward
    from hyperpocket_tpu_torch.parallel.mesh import all_gather_cat
    from hyperpocket_tpu_torch.parallel.point_sharding import (
        chamfer_loss_point_sharded,
        nn_distance_point_sharded,
        shard_points,
    )

    rank, world = dist.get_rank(), dist.get_world_size()
    pairs = [dist.new_group([r, r + 1]) for r in range(0, world, 2)]
    out = {}
    for n, m in ((2048, 2048), (1024, 2048)):
        a, b = points(8, n, 1, device), points(8, m, 2, device)
        want = nn_forward(a, b)
        wa, wb = nn_backward(a, b, want[1], want[3], torch.ones_like(want[0]),
                             torch.ones_like(want[2]))
        for name, group in (("world", dist.group.WORLD), ("pairs", pairs[rank // 2])):
            al = shard_points(a, group).clone().requires_grad_(True)
            bl = shard_points(b, group).clone().requires_grad_(True)
            got = [all_gather_cat(t, group, dim=1) for t in nn_distance_point_sharded(al, bl, group)]
            for g, w, what in zip(got, want, ("d1", "i1", "d2", "i2")):
                check(torch.equal(g, w), f"ring {name} {n}x{m}: {what} differs")
            loss = chamfer_loss_point_sharded(al, bl, group)
            ref = want[0].sum() + want[2].sum()
            rel = abs(loss.item() - ref.item()) / abs(ref.item())
            check(rel <= 1e-5, f"ring {name} {n}x{m}: value relative error {rel}")
            ga, gb = torch.autograd.grad(loss, (al, bl))
            ga, gb = all_gather_cat(ga, group, dim=1), all_gather_cat(gb, group, dim=1)
            err = max((ga - wa).abs().max().item(), (gb - wb).abs().max().item())
            check(err <= 1e-5, f"ring {name} {n}x{m}: gradient error {err}")
            out[f"{name}_{n}x{m}"] = {"value_rel": rel, "grad_err": err}
    return out


def pairs(device) -> dict:
    from hyperpocket_tpu_torch.eval.metrics import pairwise_emd_cd_multi
    from hyperpocket_tpu_torch.parallel import make_mesh

    rows = points(16, 1024, 3, device)
    cols = points(32, 1024, 4, device).view(2, 16, 1024, 3)
    got = pairwise_emd_cd_multi(rows, cols, 512, mesh=make_mesh(dist.get_world_size(), 1))
    want = pairwise_emd_cd_multi(rows, cols, 512)
    check(all((g == w).all() for g, w in zip(got, want)), "sharded pairs differ")
    return {"pairs": 512, "equal": True}


def chair(compute_dtype: str, seed: int):
    from hyperpocket_tpu_torch.models.full_model import FullModel

    config = json.loads((ROOT / "settings" / "config_3depn_chair.json").read_text())
    config["full_model"]["compute_dtype"] = compute_dtype
    return config, FullModel.from_config(config["full_model"], torch.Generator().manual_seed(seed))


def serve(device) -> dict:
    from hyperpocket_tpu_torch import serving
    from hyperpocket_tpu_torch.parallel import make_mesh

    _, model = chair("bfloat16", 5)
    existing = points(256, 1024, 6, device)
    noise = points(256, model.get_noise_size(), 7, device)[..., 0] * 0.1
    dp = serving.make_serving_fn(model, num_output_points=2048, device=device,
                                 mesh=make_mesh(dist.get_world_size(), 1))
    got = dp(existing, noise, 8)
    want = serving.make_serving_fn(model, num_output_points=2048, device=device)(
        existing, noise, 8)
    err = ((got - want).abs().max() / want.abs().max()).item()
    check(err <= 2e-2, f"DP serving vs one process {err}")
    rank0 = got.clone()
    dist.broadcast(rank0, 0)
    check(torch.equal(got, rank0), "ranks' DP serving outputs differ")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(20):
        dp(existing, noise, s)
    torch.cuda.synchronize()
    return {"rel_err": err, "clouds_per_s_per_rank_call": 256 * 20 / (time.perf_counter() - t0)}


def train(device) -> dict:
    from hyperpocket_tpu_torch.parallel import mesh as pmesh
    from hyperpocket_tpu_torch.train import optim, trainer

    config, base = chair("float32", 9)
    base = base.to(device)
    tr = config["training"]
    world = dist.get_world_size()
    batch = 8
    existing, missing = points(batch, 1024, 10, device), points(batch, 1024, 11, device)
    gt = points(batch, 2048, 12, device)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        results = {}
        for tag, mesh in (("one", None), ("mesh", pmesh.make_mesh(world // 2, 2))):
            model = copy.deepcopy(base)
            if mesh is not None:
                pmesh.shard_params(mesh, model)
            opt = optim.make_optimizer(tr["optimizer"], optim.trainable_parameters(model))
            step = trainer.make_train_step(model, opt, float(tr["loss_coef"]), mesh)
            gen = torch.Generator(device=device).manual_seed(13)
            rows = slice(None) if mesh is None else pmesh.batch_rows(mesh, batch)
            losses = [step(existing[rows], missing[rows], gt[rows], gen, 1.0, 2048)[0].item()
                      for _ in range(2)]
            with pmesh.unsharded(mesh, model, opt):
                shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
            results[tag] = (losses, shapes)
    finally:
        torch.use_deterministic_algorithms(False)
    (one, one_shapes), (got, got_shapes) = results["one"], results["mesh"]
    rel = [abs(g - w) / abs(w) for g, w in zip(got, one)]
    check(rel[0] <= 1e-5 and rel[1] <= 1e-3, f"DP x TP losses {got} vs one process {one}")
    check(got_shapes == one_shapes, "gathered parameter shapes differ")
    return {"mesh": [world // 2, 2], "losses": got, "one_process": one, "rel": rel}


def main() -> int:
    from hyperpocket_tpu_torch.parallel import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    check(distributed.initialize_multihost(device="cuda"), "no torchrun environment")
    device = distributed.rank_device("cuda")
    world = dist.get_world_size()
    check(world % 2 == 0 and world >= 2, f"needs an even world size, got {world}")
    try:
        res = {"world": world, "backend": dist.get_backend(),
               "card": torch.cuda.get_device_name(device)}
        for name, fn in (("ring", ring), ("pairs", pairs), ("serve", serve), ("train", train)):
            res[name] = fn(device)
            dist.barrier()
        if dist.get_rank() == 0:
            print(json.dumps(res))
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
