"""Worker processes of tests/test_torch_parallel_*.py: torch and the port only.

``spawn(tasks, world, out_dir)`` starts ``world`` processes (one gloo group
over a file store in ``out_dir``, so parallel test processes never race for
a port); each runs the named tasks in order and rank 0 writes each task's
results to ``out_dir/<task>.npz`` (or files under ``out_dir``). The test
modules compare them with one-process runs of the port and with the JAX
package, which run in the test process.
"""

from __future__ import annotations

import json
import os
import traceback
from os.path import join

import numpy as np
import torch
import torch.distributed as dist

TASKS: dict = {}


def task(fn):
    TASKS[fn.__name__] = fn
    return fn


def spawn(tasks: list[tuple[str, dict]], world: int, out_dir: str) -> None:
    """Run ``tasks`` (name, keyword arguments) on ``world`` gloo ranks."""
    import torch.multiprocessing as mp

    mp.spawn(_entry, args=(world, str(out_dir), tasks), nprocs=world, join=True)


def _entry(rank: int, world: int, out_dir: str, tasks) -> None:
    torch.set_num_threads(1)
    from hyperpocket_tpu_torch.parallel import distributed

    assert distributed.initialize_multihost(f"file://{out_dir}/store", world, rank,
                                            device="cpu")
    try:
        for name, kwargs in tasks:
            try:
                TASKS[name](out_dir=out_dir, **kwargs)
            except Exception:  # one failing task must not hide the others' results
                if rank == 0:
                    with open(join(out_dir, f"{name}.error"), "w") as fh:
                        fh.write(traceback.format_exc())
                raise
    finally:
        distributed.shutdown()


def _save(out_dir: str, name: str, **arrays) -> None:
    if dist.get_rank() == 0:
        np.savez(join(out_dir, f"{name}.npz"), **arrays)


def _gather_rows(t: torch.Tensor, group=None, dim: int = 0) -> np.ndarray:
    from hyperpocket_tpu_torch.parallel.mesh import all_gather_cat

    return all_gather_cat(t.detach(), dist.group.WORLD if group is None else group,
                          dim).numpy()


# ---------------------------------------------------------------------------
# Process group and loader


@task
def group_basics(out_dir: str) -> None:
    from hyperpocket_tpu_torch.data.loader import BatchLoader
    from hyperpocket_tpu_torch.parallel import distributed, make_mesh

    rank, world = distributed.rank(), distributed.world_size()
    sl = distributed.local_batch_slice(8)
    again = distributed.initialize_multihost(device="cpu")  # idempotent
    items = [(np.full((4, 3), i, np.float32), np.zeros((2, 3), np.float32),
              np.zeros((4, 3), np.float32), "cat") for i in range(10)]
    loader = BatchLoader(items, 4, shuffle=True, drop_last=True, num_workers=0, seed=3,
                         process_shard=(rank, world))
    rows = np.stack([ex[:, 0, 0] for ex, *_ in loader.epoch(2)])  # (batches, 4 / world)
    errors = []
    for n_data, n_model in ((world + 1, 1), (1, 1)):
        try:
            make_mesh(n_data, n_model)
        except ValueError as exc:
            errors.append(str(exc))
    total = torch.tensor([float(rank + 1)])
    dist.all_reduce(total)
    every = _gather_rows(torch.tensor([[rank, sl.start, sl.stop, int(again)]]))
    shards = _gather_rows(torch.from_numpy(rows)[None])
    _save(out_dir, "group_basics", every=every, shards=shards, total=total.numpy(),
          errors=np.array(errors))


# ---------------------------------------------------------------------------
# Train steps and the Trainer


def _model(cfg: dict, state_path: str):
    from hyperpocket_tpu_torch.models.full_model import FullModel

    model = FullModel.from_config(cfg).to(torch.float64)
    with np.load(state_path) as data:
        model.load_state_dict({k: torch.from_numpy(data[k]) for k in data.files})
    return model


@task
def train_steps(out_dir: str, cfg: dict, state_path: str, data_path: str, n_model: int,
                adam: dict, average: bool = False) -> None:
    """The data-parallel (x tensor-parallel) train step on the global batches
    of ``data_path`` with their injected draws; rank 0 saves the per-step
    losses and the full parameters after each step. ``average`` divides the
    reduced gradients by the data-axis size, as DistributedDataParallel
    does, for the test that this is wrong."""
    from hyperpocket_tpu_torch.convert import jax_leaves
    from hyperpocket_tpu_torch.parallel import mesh as pmesh
    from hyperpocket_tpu_torch.train import optim, trainer

    mesh = pmesh.make_mesh(None, n_model)
    model = _model(cfg, state_path)
    specs = pmesh.shard_params(mesh, model)
    local_shapes = {n: list(p.shape) for n, p in model.named_parameters()}
    opt = optim.make_optimizer(adam, optim.trainable_parameters(model))
    step = trainer.make_train_step(model, opt, 0.05, mesh)
    if average:
        inner = opt.step

        def averaged_step(closure=None):
            for group in opt.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad /= mesh.size(pmesh.DATA_AXIS)
            return inner(closure)

        opt.step = averaged_step
    with np.load(data_path) as data:
        d = {k: torch.from_numpy(data[k]) for k in data.files}
    losses, params = [], []
    for k in range(d["existing"].shape[0]):
        rows = pmesh.batch_rows(mesh, d["existing"].shape[1])
        out = step(d["existing"][k][rows], d["missing"][k][rows], d["gt"][k][rows], None, 1.0,
                   d["gt"].shape[2], vae_eps=d["vae_eps"][k], ball_points=d["ball_points"][k])
        losses.append([v.item() for v in out[:3]])
        with pmesh.unsharded(mesh, model):
            params.append([t.numpy().copy() for t in jax_leaves(model)])
    adam_state = {}
    with pmesh.unsharded(mesh, model, opt):
        for name, p in model.named_parameters():
            if specs[name] is not None:
                adam_state[name] = opt.state[p]["exp_avg"].numpy().copy()
    out = {"losses": np.asarray(losses)}
    out.update({f"p{k}_{i}": a for k, leaves in enumerate(params) for i, a in enumerate(leaves)})
    out.update({f"m_{n}": a for n, a in adam_state.items()})
    if dist.get_rank() == 0:
        with open(join(out_dir, f"train_steps_{n_model}{'_avg' * average}.json"), "w") as fh:
            json.dump({"specs": specs, "local_shapes": local_shapes,
                       "moment_shapes": {n: list(opt.state[p]["exp_avg"].shape)
                                         for n, p in model.named_parameters()
                                         if p in opt.state}}, fh)
    _save(out_dir, f"train_steps_{n_model}{'_avg' * average}", **out)


@task
def trainer_run(out_dir: str, config: dict, tag: str, n_model: int,
                epoch_mode: str = "step") -> None:
    """A Trainer with ``training.parallel = {data: null, model: n_model}``
    and ``epoch_mode`` runs its config's epochs (resuming from its results
    tree, if one holds a checkpoint); rank 0 saves the losses, the seed
    counter and the scanned epochs' counts."""
    from hyperpocket_tpu_torch.train import trainer

    config = json.loads(json.dumps(config))
    config["training"]["parallel"] = {"data": None, "model": n_model}
    config["training"]["epoch_mode"] = epoch_mode
    t = trainer.Trainer(config, device="cpu")
    rows = []
    inner = t.train_epoch

    def recorded(epoch):
        out = inner(epoch)
        rows.append(np.asarray(t.last_step_losses, np.float64).copy())
        return out

    t.train_epoch = recorded
    train, val = t.run(plot_samples=False)
    _save(out_dir, f"trainer_{tag}", train=np.asarray(train), val=np.asarray(val),
          rows=np.concatenate(rows) if rows else np.zeros((0, 3)),
          seed_counter=np.int64(t._seed_counter), start_epoch=np.int64(t.start_epoch),
          mesh=np.asarray([t.mesh.size("data"), t.mesh.size("model")]),
          scan_counts=np.asarray([t.scan_invocations, t.val_scan_invocations]),
          writers=_gather_rows(torch.tensor([int(t.is_writer)])))


# ---------------------------------------------------------------------------
# The ring


@task
def ring(out_dir: str, cases: list[tuple[int, int, int, int]]) -> None:
    """For each (batch, N, M, seed): the ring over the whole world and over
    rank pairs, fp64. Rank 0 saves each ring's gathered outputs, Chamfer
    value and gradients."""
    from hyperpocket_tpu_torch.parallel.point_sharding import (
        chamfer_loss_point_sharded,
        nn_distance_point_sharded,
        shard_points,
    )

    rank, world = dist.get_rank(), dist.get_world_size()
    pairs = [dist.new_group([r, r + 1]) for r in range(0, world, 2)]
    rings = {world: dist.group.WORLD, 2: pairs[rank // 2]}
    out = {}
    for k, (batch, n, m, seed) in enumerate(cases):
        g = torch.Generator().manual_seed(seed)
        a = torch.randn(batch, n, 3, generator=g, dtype=torch.float64)
        b = torch.randn(batch, m, 3, generator=g, dtype=torch.float64)
        for size, group in rings.items():
            al = shard_points(a, group).clone().requires_grad_(True)
            bl = shard_points(b, group).clone().requires_grad_(True)
            d1, i1, d2, i2 = nn_distance_point_sharded(al, bl, group)
            value = chamfer_loss_point_sharded(al, bl, group)
            value.backward()
            for name, t in (("d1", d1), ("i1", i1), ("d2", d2), ("i2", i2),
                            ("ga", al.grad), ("gb", bl.grad)):
                out[f"{k}_{size}_{name}"] = _gather_rows(t, group, dim=1)
            out[f"{k}_{size}_value"] = value.detach().numpy()
    errors = []
    try:
        shard_points(torch.zeros(1, 4 * world + 2, 3))
    except ValueError as exc:
        errors.append(str(exc))
    try:  # shards of different sizes on different ranks
        nn_distance_point_sharded(torch.zeros(1, 4 + rank, 3), torch.zeros(1, 4, 3))
    except ValueError as exc:
        errors.append(str(exc))
    _save(out_dir, "ring", errors=np.array(errors), **out)


# ---------------------------------------------------------------------------
# Eval and serving


class RecordedDraws:
    """Replays the noise and ball draws a run recorded, by counter value."""

    def __init__(self, path: str):
        with np.load(path) as data:
            self.arrays = {k: data[k] for k in data.files}

    def noise(self, seed, batch, mean, std, source):
        return torch.from_numpy(self.arrays[f"noise_{int(seed)}"])

    def balls(self, seed, batch, num_points, epoch):
        return torch.from_numpy(self.arrays[f"balls_{int(seed)}"])


@task
def eval_pairs(out_dir: str, rows_path: str, generativity: dict) -> None:
    """``pairwise_emd_cd_multi`` over the data mesh, and
    ``evaluate_generativity(parallel_data=world)`` on recorded draws."""
    from hyperpocket_tpu_torch.eval import experiments, metrics
    from hyperpocket_tpu_torch.models.full_model import FullModel
    from hyperpocket_tpu_torch.parallel import make_mesh

    world = dist.get_world_size()
    mesh = make_mesh(world, 1)
    with np.load(rows_path) as data:
        rows, cols = data["rows"], data["cols"]
    out = {}
    for block in (64, 37):
        cd, emd = metrics.pairwise_emd_cd_multi(rows, cols, pair_block=block, device="cpu",
                                                mesh=mesh)
        out[f"cd_{block}"], out[f"emd_{block}"] = cd, emd
    with np.load(generativity["state_path"]) as data:
        state = {k: torch.from_numpy(data[k]) for k in data.files}
    model = FullModel.from_config(generativity["cfg"])
    model.load_state_dict(state)
    ctx = experiments.ExperimentContext(model.eval(), epoch=5, seed=7, device="cpu",
                                        draws=RecordedDraws(generativity["draws_path"]))
    with np.load(generativity["objects_path"]) as data:
        objs = [(data["existing"][i], data["missing"][i], data["gt"][i], "chair")
                for i in range(data["existing"].shape[0])]
    res = experiments.evaluate_generativity(ctx, {"chair": objs}, out_dir, 5, batch_size=3,
                                            dispatch_clouds=8, include_1nna=True,
                                            parallel_data=world)
    errors = []
    try:
        experiments.evaluate_generativity(ctx, {"chair": objs}, out_dir, 5,
                                          parallel_data=world + 1)
    except ValueError as exc:
        errors.append(str(exc))
    with open(join(out_dir, f"generativity_rank{dist.get_rank()}.json"), "w") as fh:
        json.dump(res, fh)
    _save(out_dir, "eval_pairs", errors=np.array(errors), **out)


@task
def serve(out_dir: str, cfg: dict, state_path: str, inputs_path: str, artifact_path: str,
          num_output_points: int, epoch: float) -> None:
    """Data-parallel ``make_serving_fn`` and a ``data_parallel=world`` artifact."""
    from hyperpocket_tpu_torch import serving
    from hyperpocket_tpu_torch.models.full_model import FullModel
    from hyperpocket_tpu_torch.parallel import make_mesh

    world = dist.get_world_size()
    model = FullModel.from_config(cfg)
    with np.load(state_path) as data:
        model.load_state_dict({k: torch.from_numpy(data[k]) for k in data.files})
    with np.load(inputs_path) as data:
        existing, noise = data["existing"], data["noise"]
    f = serving.make_serving_fn(model, num_output_points=num_output_points, epoch=epoch,
                                device="cpu", mesh=make_mesh(world, 1))
    g = serving.load_completion(open(artifact_path, "rb").read())
    _save(out_dir, "serve", fn=f(existing, noise, 5).numpy(),
          artifact=g(existing, noise, 5).numpy(), world=np.int64(world))
