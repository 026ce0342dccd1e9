"""The port's data-parallel layer on two gloo ranks vs one process and the JAX mesh.

One spawn of two CPU processes (``tests/torch_parallel_workers.py``, a file
store in the module's temp dir) runs every parallel case of this module;
the assertions compare its results with one-process runs of the port and
with the JAX package on conftest's virtual devices, here.

* The process group: ``initialize_multihost`` (idempotent, a no-op in one
  process), ``local_batch_slice``, ``make_mesh``'s errors.
* ``BatchLoader(process_shard=)``: each rank's rows are the JAX loader's.
* Three fp64 train steps at data=2 with injected draws equal the port's
  one-process steps (rtol 1e-10) and the JAX train step on
  ``make_mesh(2, 1)`` within the fp64 trajectory budget of
  tests/test_torch_train.py (1e-9 per step); gradients averaged over the
  data axis, as DistributedDataParallel does, fail that match.
* A ``Trainer`` at data=2 (fp64, two epochs, the val epoch sharded where
  its batch divides) gives the one-process run's per-step and epoch
  losses (rtol 1e-10), seed counter and saved leaves.
"""

from __future__ import annotations

import shutil
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperpocket_tpu.data import loader as jloader
from hyperpocket_tpu.models import full_model as jfm
from hyperpocket_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hyperpocket_tpu.parallel.mesh import replicate as jax_replicate
from hyperpocket_tpu.parallel.mesh import shard_batch as jax_shard_batch
from hyperpocket_tpu.train import optim as joptim
from hyperpocket_tpu.train import trainer as jtrainer
from hyperpocket_tpu_torch.convert import params_from_jax, params_to_jax
from hyperpocket_tpu_torch.data import loader as ploader
from hyperpocket_tpu_torch.models.full_model import FullModel
from hyperpocket_tpu_torch.parallel import distributed
from hyperpocket_tpu_torch.train import optim, trainer
from hyperpocket_tpu_torch.train.config import get_results_dir_path
from tests.test_data import make_synthetic_shapenet
from tests.test_torch_models import tiny_config
from tests.test_train_integration import make_config
from tests.torch_parallel_workers import spawn

RTOL = 1e-10
WORLD = 2
K, B, N_EX, N_GT = 3, 4, 32, 64
ADAM = {"type": "Adam", "hyperparams": {"lr": 1e-3, "weight_decay": 0, "betas": [0.9, 0.999],
                                        "amsgrad": False}}


def step_data(seed: int = 5) -> dict[str, np.ndarray]:
    """K global batches of B clouds and their draws, in fp64: with fp32 ground
    truth the JAX package's jitted Chamfer rounds part of its distance
    expansion in fp32 (tests/test_torch_trainer.py)."""
    rng = np.random.default_rng(seed)
    z = tiny_config()["random_encoder"]["output_size"]
    return {
        "existing": rng.standard_normal((K, B, N_EX, 3)) * 0.3,
        "missing": rng.standard_normal((K, B, N_EX, 3)) * 0.3,
        "gt": rng.standard_normal((K, B, N_GT, 3)) * 0.3,
        "vae_eps": rng.standard_normal((K, B, z)),
        "ball_points": rng.uniform(-0.5, 0.5, (K, B, N_GT, 3)),
    }


def jax_init_fp64(cfg: dict, seed: int = 11):
    """(JAX model, fp64 params, the port's fp64 state_dict of them)."""
    jmodel = jfm.FullModel.from_config(cfg)
    with jax.enable_x64(True):
        params = jax.device_get(jmodel.init(jax.random.key(seed), dtype=jnp.float64))
    return jmodel, params, params_from_jax(params, torch.float64)


def port_steps(cfg: dict, state: dict, data: dict, adam: dict = ADAM):
    """The port's one-process steps: (losses (K, 3), JAX-layout leaves after each step)."""
    model = FullModel.from_config(cfg).to(torch.float64)
    model.load_state_dict(state)
    step = trainer.make_train_step(model, optim.make_optimizer(adam, model.parameters()), 0.05)
    d = {k: torch.from_numpy(v) for k, v in data.items()}
    losses, leaves = [], []
    for k in range(K):
        out = step(d["existing"][k], d["missing"][k], d["gt"][k], None, 1.0, N_GT,
                   vae_eps=d["vae_eps"][k], ball_points=d["ball_points"][k])
        losses.append([v.item() for v in out[:3]])
        leaves.append([np.array(a, copy=True)  # the next step updates the tensors in place
                       for a in jax.tree_util.tree_leaves(params_to_jax(model))])
    return np.asarray(losses), leaves


def jax_mesh_steps(jmodel, params, data: dict, n_data: int, n_model: int = 1):
    """The JAX train step on a (n_data, n_model) mesh, fp64: (losses, leaves per step)."""
    with jax.enable_x64(True):
        mesh = jax_make_mesh(n_data, n_model)
        tx = joptim.make_optimizer(ADAM)
        p = jax_replicate(mesh, jax.tree_util.tree_map(jnp.asarray, params))
        o = jax_replicate(mesh, tx.init(p))
        step = jtrainer.make_train_step(jmodel, tx, 0.05)
        losses, leaves = [], []
        for k in range(K):
            ex, mi, gt = jax_shard_batch(mesh, *(jnp.asarray(data[n][k])
                                                 for n in ("existing", "missing", "gt")))
            p, o, *out, _ = step(p, o, ex, mi, gt, np.uint32(k), jnp.asarray(1.0),
                                 num_points=N_GT, vae_eps=jnp.asarray(data["vae_eps"][k]),
                                 ball_points=jnp.asarray(data["ball_points"][k]))
            losses.append([float(v) for v in out])
            # copies: the next step donates these buffers
            leaves.append([np.array(a, copy=True) for a in jax.tree_util.tree_leaves(p)])
    return np.asarray(losses), leaves


def assert_trajectory(got_losses, got_leaves, want_losses, want_leaves, rtol: float,
                      param_rtol: float | None = None) -> None:
    """Losses within ``rtol``; each leaf after each step within ``param_rtol``
    (default ``rtol``) of its largest magnitude."""
    param_rtol = rtol if param_rtol is None else param_rtol
    np.testing.assert_allclose(got_losses, want_losses, rtol=rtol, atol=0)
    for got, want in zip(got_leaves, want_leaves):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.float64
            assert np.abs(g - w).max() <= param_rtol * max(np.abs(w).max(), 1e-30)


def worker_leaves(npz, k: int) -> list[np.ndarray]:
    n = sum(1 for f in npz.files if f.startswith(f"p{k}_"))
    return [npz[f"p{k}_{i}"] for i in range(n)]


def trainer_config(data_root, results_root, max_epoch: int = 2) -> dict:
    config = make_config(data_root, results_root, max_epoch=max_epoch, batch=2)
    config["training"].update(param_dtype="float64", compute_dtype="float64")
    for part in ("train", "val"):
        config["training"]["dataloader"][part]["num_workers"] = 0
    return config


def make_data_root(root):
    """The synthetic tree with 4 train and 3 val objects: at batch 2 the
    val epoch has one batch that splits over two ranks and one that does not."""
    names = make_synthetic_shapenet(root, n_models=8, n_gt=N_GT, n_part=32)
    for split, sel in (("train", names[:4]), ("val", names[4:7]), ("test", names[7:])):
        with open(join(root, split + ".list"), "w") as fh:
            fh.write("\n".join(sel) + "\n")
    return root


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    cfg = tiny_config(compute_dtype="float64")
    _, params, state = jax_init_fp64(cfg)
    np.savez(out / "state.npz", **{k: v.numpy() for k, v in state.items()})
    np.savez(out / "data.npz", **step_data())
    data_root = make_data_root(tmp_path_factory.mktemp("data"))
    steps = dict(cfg=cfg, state_path=str(out / "state.npz"), data_path=str(out / "data.npz"),
                 n_model=1, adam=ADAM)
    spawn([("group_basics", {}),
           ("train_steps", steps),
           ("train_steps", {**steps, "average": True}),
           ("trainer_run", dict(config=trainer_config(data_root, out / "dp"), tag="dp",
                                n_model=1))], WORLD, out)
    return {"out": out, "cfg": cfg, "params": params, "state": state, "data_root": data_root}


def _npz(run, name):
    return np.load(run["out"] / f"{name}.npz")


def test_process_group_and_local_batch_slice(run):
    res = _npz(run, "group_basics")
    # rank, local_batch_slice(8), initialize_multihost again (idempotent -> True)
    np.testing.assert_array_equal(res["every"], [[0, 0, 4, 1], [1, 4, 8, 1]])
    assert float(res["total"][0]) == 3.0
    assert "mesh 3x1 needs 3 devices, have 2" in res["errors"][0]
    assert "leaves 1 of 2 ranks out" in res["errors"][1]


def test_single_process_initialize_is_a_noop(monkeypatch):
    """The cases of tests/test_utils.py and tests/test_multihost.py in one process."""
    for name in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize_multihost(device="cpu") is False
    assert distributed.world_size() == 1 and distributed.rank() == 0
    assert distributed.local_batch_slice(64) == slice(0, 64)
    assert distributed.rank_device("cpu") == torch.device("cpu")


def test_loader_shards_are_the_jax_loaders(run):
    items = [(np.full((4, 3), i, np.float32), np.zeros((2, 3), np.float32),
              np.zeros((4, 3), np.float32), "cat") for i in range(10)]
    shards = _npz(run, "group_basics")["shards"]  # (ranks, batches, rows)
    for rank in range(WORLD):
        jl = jloader.BatchLoader(items, 4, shuffle=True, drop_last=True, num_workers=0, seed=3,
                                 process_shard=(rank, WORLD))
        want = np.stack([ex[:, 0, 0] for ex, *_ in jl.epoch(2)])
        np.testing.assert_array_equal(shards[rank], want)
    # every rank's rows together are the one-process batches
    one = np.stack([ex[:, 0, 0] for ex, *_ in ploader.BatchLoader(
        items, 4, shuffle=True, drop_last=True, num_workers=0, seed=3).epoch(2)])
    np.testing.assert_array_equal(np.concatenate(list(shards), axis=1), one)
    for mod in (jloader, ploader):
        with pytest.raises(ValueError, match="not divisible by process_count 3"):
            mod.BatchLoader(items, 4, drop_last=True, process_shard=(0, 3))
        with pytest.raises(ValueError, match="requires drop_last=True"):
            mod.BatchLoader(items, 4, drop_last=False, process_shard=(0, 2))


def test_dp_steps_match_one_process_and_the_jax_mesh_fp64(run):
    res = _npz(run, "train_steps_1")
    got_leaves = [worker_leaves(res, k) for k in range(K)]
    data = step_data()
    one_losses, one_leaves = port_steps(run["cfg"], run["state"], data)
    assert_trajectory(res["losses"], got_leaves, one_losses, one_leaves, RTOL)
    jmodel = jfm.FullModel.from_config(run["cfg"])
    jax_losses, jax_leaves = jax_mesh_steps(jmodel, run["params"], data, WORLD)
    assert_trajectory(res["losses"], got_leaves, jax_losses, jax_leaves, 1e-9, 1e-8)
    assert res["losses"][-1, 0] < res["losses"][0, 0]


def test_averaged_gradients_miss_the_one_process_steps(run):
    """DistributedDataParallel's mean over ranks is 1/world of the loss's
    gradient: the first update already leaves the one-process trajectory."""
    res = _npz(run, "train_steps_1_avg")
    one_losses, one_leaves = port_steps(run["cfg"], run["state"], step_data())
    np.testing.assert_allclose(res["losses"][0], one_losses[0], rtol=RTOL)  # before any update
    with pytest.raises(AssertionError):
        assert_trajectory(res["losses"], [worker_leaves(res, k) for k in range(K)],
                          one_losses, one_leaves, 1e-6)


def test_dp_trainer_matches_the_one_process_trainer(run, tmp_path):
    res = _npz(run, "trainer_dp")
    np.testing.assert_array_equal(res["mesh"], [WORLD, 1])
    np.testing.assert_array_equal(res["writers"], [1, 0])
    t = trainer.Trainer(trainer_config(run["data_root"], tmp_path / "one"), device="cpu")
    rows = []
    inner = t.train_epoch

    def recorded(epoch):
        out = inner(epoch)
        rows.append(np.asarray(t.last_step_losses, np.float64).copy())
        return out

    t.train_epoch = recorded
    train, val = t.run(plot_samples=False)
    assert t.mesh is None
    np.testing.assert_allclose(res["rows"], np.concatenate(rows), rtol=RTOL)
    np.testing.assert_allclose(res["train"], np.asarray(train), rtol=RTOL)
    np.testing.assert_allclose(res["val"], np.asarray(val), rtol=RTOL)
    assert int(res["seed_counter"]) == t._seed_counter
    dp_weights = join(get_results_dir_path(trainer_config(run["data_root"], run["out"] / "dp"),
                                           "training"), "weights")
    for name in ("00002_model.npz", "00002_O.npz"):
        with np.load(join(dp_weights, name)) as got, np.load(join(t.weights_path, name)) as want:
            assert got.files == want.files
            for f in want.files:
                w = want[f]
                assert np.abs(got[f] - w).max() <= RTOL * max(np.abs(w).max(), 1e-30), (name, f)
    shutil.rmtree(tmp_path / "one")
