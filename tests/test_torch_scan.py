"""The port's scanned epochs (``training.epoch_mode: "scan"``) against its step loop, on the CPU.

The cases of tests/test_trainer_scan.py, held to the port's step loop bit
for bit (on the CPU the scanned epoch runs the step eagerly on its static
buffers, so any difference in draws, counter values, order or arithmetic
shows): the train trajectory (loss rows, parameters, optimizer state, the
sample capture) in fp64 and fp32 with and without a ragged tail, the val
losses and samples, ``epoch_mode`` validated, and scan under a gloo mesh of
two ranks (tests/torch_parallel_workers.py). The port's own cases: a
one-batch epoch is not scanned, ``injection_provider`` runs the step loop,
the ``compute_dtype_switch`` crossing, a resume, each optimizer with its
count on the device and an lr schedule, and the optimizers written in the
port against their arithmetic before the count moved to the device. The
kept graph's parts that the CPU can hold: the signature a card's
``EpochScan`` replays its graph under (it changes with a hyperparameter,
the compute dtype, a buffer's shape, the optimizer's state, and not with
the epoch), a step body that never reads the epoch, and the counters a
capture collects and a replay adds again under a profiler only. One case
runs the JAX Trainer in scan mode beside the port's and compares their
counters and loss-row shapes.
"""

from __future__ import annotations

import contextlib
import copy
from os.path import join

import numpy as np
import pytest
import torch

from hyperpocket_tpu_torch.train import optim, trainer
from hyperpocket_tpu_torch.train.config import get_results_dir_path
from hyperpocket_tpu_torch.train.epoch_scan import upload_stacked
from tests.test_data import make_synthetic_shapenet
from tests.test_train_integration import make_config
from tests.torch_parallel_workers import spawn

EPOCHS = 2


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """7 train and 5 val objects: at batch 2, 3 train batches (and a ragged
    one without drop_last) and 2 val batches with a ragged one."""
    root = tmp_path_factory.mktemp("data")
    names = make_synthetic_shapenet(root, n_models=12, n_gt=64, n_part=32)
    for split, sel in (("train", names[:7]), ("val", names[7:]), ("test", names[:1])):
        with open(join(root, split + ".list"), "w") as fh:
            fh.write("\n".join(sel) + "\n")
    return root


def _config(root, results, mode: str, dtype: str = "float64", drop_last: bool = True,
            batch: int = 2, max_epoch: int = EPOCHS, saves: bool = False, **training) -> dict:
    """The tiny training config; checkpoints only with ``saves`` (each one
    is tens of MB of fp64 hypernetwork)."""
    config = make_config(root, results, max_epoch=max_epoch, batch=batch)
    config["training"].update(param_dtype="float64" if dtype == "float64" else "float32",
                              compute_dtype=dtype, epoch_mode=mode,
                              min_save_epoch=0 if saves else max_epoch, **training)
    for part in ("train", "val"):
        config["training"]["dataloader"][part].update(num_workers=0, drop_last=drop_last)
    return config


def _run(config, inject=None) -> dict:
    """``Trainer.run`` with every train epoch's rows, sample and val result recorded."""
    t = trainer.Trainer(config, device="cpu")
    t.injection_provider = inject
    rec = {"rows": [], "latest": [], "val": []}
    train_epoch, val_epoch = t.train_epoch, t.val_epoch

    def recorded_train(epoch):
        stats, latest = train_epoch(epoch)
        rec["rows"].append(t.last_step_losses.copy())
        rec["latest"].append(latest)
        return stats, latest

    def recorded_val(epoch):
        out = val_epoch(epoch)
        rec["val"].append(out)
        return out

    t.train_epoch, t.val_epoch = recorded_train, recorded_val
    rec["curves"] = t.run(plot_samples=False)
    rec["params"] = {k: v.detach().clone() for k, v in t.model.state_dict().items()}
    rec["state"] = {name: {k: v.clone() for k, v in t.optimizer.state[p].items()}
                    for name, p in t.model.named_parameters() if p in t.optimizer.state}
    rec["counters"] = (t.scan_invocations, t.val_scan_invocations)
    rec["trainer"] = t
    return rec


def _equal(a, b, what: str) -> None:
    """Bit-equal nested results: arrays, tensors, dicts, tuples."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), what
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), what
    else:
        assert a == b, what


def _same_run(scan: dict, step: dict) -> None:
    for key in ("rows", "latest", "val", "curves", "params", "state"):
        _equal(scan[key], step[key], key)
    assert np.isfinite(np.concatenate(scan["rows"])).all()
    t_scan, t_step = scan["trainer"], step["trainer"]
    assert t_scan.updates == t_step.updates and t_scan._seed_counter == t_step._seed_counter


@pytest.fixture(scope="module")
def pairs(data_root, tmp_path_factory):
    """(scan run, step run) for each (dtype, drop_last), made when first asked for."""
    cache = {}

    def get(dtype: str, drop_last: bool):
        if (dtype, drop_last) not in cache:
            out = tmp_path_factory.mktemp(f"pair_{dtype}_{drop_last}")
            cache[dtype, drop_last] = tuple(
                _run(_config(data_root, out / mode, mode, dtype, drop_last))
                for mode in ("scan", "step"))
        return cache[dtype, drop_last]

    return get


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_scan_matches_step_trajectory(pairs, dtype, drop_last):
    scan, step = pairs(dtype, drop_last)
    for key in ("rows", "latest", "curves", "params", "state"):
        _equal(scan[key], step[key], key)
    # 3 batches of 2 (+ a ragged one of 1): the prefix of 3 is scanned each epoch
    assert [r.shape for r in scan["rows"]] == [(3 + (not drop_last), 3)] * EPOCHS
    assert scan["counters"][0] == EPOCHS and step["counters"] == (0, 0)
    assert scan["trainer"].updates == step["trainer"].updates == EPOCHS * (3 + (not drop_last))
    assert scan["trainer"]._seed_counter == step["trainer"]._seed_counter
    assert scan["latest"][-1][2].shape == (1 if not drop_last else 2, 64, 3)


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_val_scan_matches_step(pairs, dtype, drop_last):
    scan, step = pairs(dtype, drop_last)
    _equal(scan["val"], step["val"], "val")
    # 5 val objects at batch 2: a scanned prefix of 2 batches (and a tail) an epoch
    assert scan["counters"][1] == EPOCHS
    losses, samples = scan["val"][-1]
    assert all(s is not None for s in samples.values()) and np.isfinite(losses["total"]).all()


def test_epoch_mode_validated(data_root, tmp_path):
    with pytest.raises(ValueError, match="epoch_mode"):
        trainer.Trainer(_config(data_root, tmp_path, "warp"), device="cpu")


def test_one_batch_epoch_is_not_scanned(data_root, tmp_path):
    """At batch 4: one train batch (drop_last) and one full val batch before
    its tail: nothing is scanned, and the run is the step loop's."""
    scan, step = (_run(_config(data_root, tmp_path / m, m, batch=4)) for m in ("scan", "step"))
    assert scan["counters"] == (0, 0)
    _same_run(scan, step)


def test_injection_provider_runs_the_step_loop(data_root, tmp_path):
    def inject(epoch, i):
        rng = np.random.default_rng((epoch, i))
        return {"vae_eps": rng.standard_normal((2, 16)).astype(np.float32),
                "ball_points": rng.uniform(-0.5, 0.5, (2, 64, 3)).astype(np.float32)}

    scan, step = (_run(_config(data_root, tmp_path / m, m), inject) for m in ("scan", "step"))
    assert scan["counters"][0] == 0
    _same_run(scan, step)


def test_dtype_switch_crossing_under_scan(data_root, tmp_path):
    """bf16 for epoch 1, fp32 after: both epochs scanned, the step loop's run."""
    sw = {"compute_dtype_switch": {"epoch": 1, "compute_dtype": "float32"}}
    scan, step = (_run(_config(data_root, tmp_path / m, m, "bfloat16", **sw))
                  for m in ("scan", "step"))
    assert scan["trainer"].model.compute_dtype == "float32"
    assert scan["counters"] == (EPOCHS, EPOCHS)
    _same_run(scan, step)


def test_resume_under_scan_equals_the_uninterrupted_run(data_root, tmp_path):
    whole = _run(_config(data_root, tmp_path / "whole", "scan", max_epoch=3))
    _run(_config(data_root, tmp_path / "parts", "scan", max_epoch=2, saves=True))
    resumed = _run(_config(data_root, tmp_path / "parts", "scan", max_epoch=3))
    assert resumed["trainer"].start_epoch == 3 and resumed["counters"] == (1, 1)
    _equal(resumed["rows"][0], whole["rows"][2], "epoch 3 rows")
    _equal(resumed["val"][0], whole["val"][2], "epoch 3 val")
    for key in ("params", "curves"):
        _equal(resumed[key], whole[key], key)
    # the restore fills the slots of parameters no step has updated with zeros
    for name, slots in resumed["state"].items():
        if whole["state"].get(name):
            _equal(slots, whole["state"][name], f"state.{name}")
        else:
            assert all(not v.any() for k, v in slots.items() if k != "step"), name


OPTIMIZERS = {
    "adam_lowp": ({"type": "Adam", "hyperparams": {"lr": 1e-3, "moment_dtype": "bfloat16"}},
                  None),
    "amsgrad": ({"type": "AdamW", "hyperparams": {"lr": 1e-3, "amsgrad": True,
                                                   "weight_decay": 0.01}}, None),
    "sgd_momentum_step_lr": ({"type": "SGD", "hyperparams": {"lr": 1e-5, "momentum": 0.9,
                                                              "nesterov": True}},
                             {"type": "StepLR", "hyperparams": {"step_size": 1, "gamma": 0.5}}),
    "rmsprop": ({"type": "RMSprop", "hyperparams": {"lr": 1e-3}}, None),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_scan_matches_step_for_each_optimizer(data_root, tmp_path, name):
    opt, sched = OPTIMIZERS[name]

    def cfg(mode):
        c = _config(data_root, tmp_path / mode, mode, "float32", drop_last=False)
        c["training"]["optimizer"] = copy.deepcopy(opt)
        if sched is not None:
            c["training"]["lr_scheduler"] = copy.deepcopy(sched)
        return c

    scan, step = _run(cfg("scan")), _run(cfg("step"))
    assert scan["counters"] == (EPOCHS, EPOCHS)
    _same_run(scan, step)
    if name != "sgd_momentum_step_lr":
        assert scan["trainer"].optimizer.param_groups[0]["lr"] == 1e-3
    else:  # StepLR halves the rate every epoch: the last epoch ran at 1e-5 / 2
        assert scan["trainer"].optimizer.param_groups[0]["lr"] == 1e-5 * 0.5


# The two optimizers written in the port as they stood before their count
# moved to the device: a Python int count, the bias correction on the host.
def _amsgrad_host_count(opt: optim.OptaxAmsgrad) -> None:
    for group in opt.param_groups:
        b1, b2 = group["betas"]
        wd = group["weight_decay"]
        for p in group["params"]:
            g = p.grad
            if wd and not group["decoupled"]:
                g = g + wd * p
            state = opt.state[p]
            if not state:
                state.update(step=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p),
                             nu_max=torch.zeros_like(p))
            state["step"] += 1
            t = state["step"]
            state["mu"].mul_(b1).add_((1 - b1) * g)
            state["nu"].mul_(b2).add_((1 - b2) * g * g)
            mu_hat = state["mu"] / (1 - b1 ** t)
            torch.maximum(state["nu_max"], state["nu"] / (1 - b2 ** t), out=state["nu_max"])
            update = mu_hat / (torch.sqrt(state["nu_max"]) + group["eps"])
            if wd and group["decoupled"]:
                update = update + wd * p
            p.add_(-group["lr"] * update)


def _adam_lowp_host_count(opt: optim.AdamLowp) -> None:
    f32 = torch.float32
    for group in opt.param_groups:
        b1, b2 = group["betas"]
        wd, md = group["weight_decay"], group["moment_dtype"]
        for p in group["params"]:
            g = p.grad
            if wd and not group["decoupled"]:
                g = g + wd * p
            state = opt.state[p]
            if not state:
                state.update(step=0, exp_avg=torch.zeros_like(p, dtype=md),
                             exp_avg_sq=torch.zeros_like(p, dtype=md))
            state["step"] += 1
            t = torch.tensor(float(state["step"]), dtype=f32)
            mu = (b1 * state["exp_avg"].to(g.dtype) + (1 - b1) * g).to(md)
            nu = (b2 * state["exp_avg_sq"].to(g.dtype) + (1 - b2) * g * g).to(md)
            state["exp_avg"], state["exp_avg_sq"] = mu, nu
            bc1 = 1 - torch.tensor(b1, dtype=f32) ** t
            bc2 = 1 - torch.tensor(b2, dtype=f32) ** t
            update = (mu.to(f32) / bc1) / (torch.sqrt(nu.to(f32) / bc2) + group["eps"])
            if wd and group["decoupled"]:
                update = update + wd * p
            p.add_((-group["lr"] * update).to(p.dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind,decoupled", [("amsgrad", False), ("amsgrad", True),
                                            ("adam_lowp", False), ("adam_lowp", True)])
def test_optimizers_keep_their_host_count_arithmetic(kind, decoupled, dtype):
    """30 updates with a tensor count on the parameter's device, bit-equal to
    the host-count arithmetic; the count is that tensor."""
    rng = np.random.default_rng(7)
    init = [torch.from_numpy(rng.standard_normal(s)).to(dtype) for s in ((5, 7), (11,))]
    grads = [[torch.from_numpy(rng.standard_normal(p.shape) * 0.1).to(dtype) for p in init]
             for _ in range(30)]
    made, plain = [[p.clone().requires_grad_() for p in init] for _ in range(2)]
    cls = optim.OptaxAmsgrad if kind == "amsgrad" else optim.AdamLowp
    reference = _amsgrad_host_count if kind == "amsgrad" else _adam_lowp_host_count
    new, old = (cls(ps, 1e-2, weight_decay=0.1, decoupled=decoupled) for ps in (made, plain))
    for step_grads in grads:
        for ps in (made, plain):
            for p, g in zip(ps, step_grads):
                p.grad = g.clone()
        new.step()
        with torch.no_grad():
            reference(old)
    for a, b in zip(made, plain):
        assert torch.equal(a, b)
    for p, q in zip(made, plain):
        for k, v in old.state[q].items():
            if k == "step":
                count = new.state[p]["step"]
                assert torch.is_tensor(count) and count.device == p.device and count.item() == v
            else:
                assert torch.equal(new.state[p][k], v), k


# The kept graph (train/epoch_scan.py): a card's EpochScan replays its graph
# across calls while ``signature`` holds. The CPU route captures nothing, so
# these hold the signature, the body and the counters the card relies on.


def _tiny_scan(data_root, tmp_path, kind: str = "train"):
    """A tiny model with AdamLowp and its train (or val) EpochScan."""
    from hyperpocket_tpu_torch.models.full_model import FullModel

    config = _config(data_root, tmp_path, "scan", "float32")
    model = FullModel.from_config(config["full_model"], torch.Generator().manual_seed(0))
    opt = optim.make_optimizer({"type": "Adam", "hyperparams": {
        "lr": 1e-3, "moment_dtype": "bfloat16"}}, optim.trainable_parameters(model))
    fn = (trainer.make_train_epoch_scan(model, opt, 1.0) if kind == "train"
          else trainer.make_val_epoch_scan(model, 1.0))
    return model, opt, fn


def _clouds(seed: int, steps: int = 2, batch: int = 2, n_gt: int = 64) -> list[torch.Tensor]:
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((steps, batch, n, 3), generator=g) * 0.3 for n in (32, 32, n_gt)]


def _static(model, clouds: list[torch.Tensor], epoch: float) -> dict:
    """A call's static buffers: its first batch and that step's draws."""
    static = dict(zip(("existing", "missing", "gt"), (c[0] for c in clouds)))
    draws = model.random_inputs(torch.Generator().manual_seed(3), clouds[0].shape[1],
                                clouds[2].shape[2], epoch)
    static["vae_eps"], static["ball_points"] = draws
    return static


SIGNATURE_CHANGES = {
    "epoch": None,
    "lr": lambda model, opt: opt.param_groups[0].update(lr=5e-4),
    "betas": lambda model, opt: opt.param_groups[0].update(betas=(0.8, 0.99)),
    "eps": lambda model, opt: opt.param_groups[0].update(eps=1e-6),
    "weight_decay": lambda model, opt: opt.param_groups[0].update(weight_decay=0.01),
    "decoupled": lambda model, opt: opt.param_groups[0].update(decoupled=True),
    "moment_dtype": lambda model, opt: opt.param_groups[0].update(moment_dtype=torch.float16),
    "compute_dtype": lambda model, opt: setattr(model, "compute_dtype", "bfloat16"),
    "buffer_shape": "gt",
    "optimizer_state": lambda model, opt: opt.load_state_dict(copy.deepcopy(opt.state_dict())),
    "deterministic_algorithms": lambda model, opt: torch.use_deterministic_algorithms(True),
}


@pytest.mark.parametrize("change", sorted(SIGNATURE_CHANGES))
def test_the_kept_graph_signature_changes_with_what_the_capture_bakes_in(data_root, tmp_path,
                                                                         change):
    """A later epoch's call keeps the signature; a parameter group's
    hyperparameter, the compute dtype, a buffer's shape, the optimizer's
    state tensors or the deterministic switch changes it."""
    model, opt, fn = _tiny_scan(data_root, tmp_path)
    clouds = _clouds(1)
    fn(*clouds, [torch.Generator().manual_seed(s) for s in range(2)], 1.0, 64)  # Adam's state
    before = fn.signature(_static(model, clouds, 1.0), 64)
    held = [v for st in opt.state.values() for v in st.values()]  # no address reused
    what = SIGNATURE_CHANGES[change]
    try:
        if what == "gt":
            clouds = _clouds(1, n_gt=128)
        elif what is not None:
            what(model, opt)
        after = fn.signature(_static(model, clouds, 9.0), 64)
        again = fn.signature(_static(model, clouds, 2.0), 64)
    finally:
        torch.use_deterministic_algorithms(False)
    assert held and (after == before) == (change == "epoch") and again == after


@pytest.mark.parametrize("kind", ["train", "val"])
def test_the_step_body_never_reads_the_epoch(data_root, tmp_path, kind):
    """The body on the CPU route with the draws given, at epochs 1 and 9
    from the same model: rows, reconstruction and parameters bit-equal, so
    a graph captured at one epoch replays any other."""
    clouds = _clouds(2)
    got = []
    for epoch in (1.0, 9.0):
        model, _, fn = _tiny_scan(data_root, tmp_path, kind)
        static = _static(model, clouds, 1.0)
        row, rec = fn.body(static["existing"], static["missing"], static["gt"], epoch, 64,
                           static["vae_eps"], static["ball_points"])
        got.append((row, rec, [p.detach().clone() for p in model.parameters()]))
    _equal(got[0], got[1], kind)
    assert np.isfinite(got[0][0].detach().numpy()).all()


@pytest.mark.parametrize("captured_under_a_profiler", [False, True])
def test_a_capture_s_counts_are_added_again_once_a_call_under_a_profiler_only(
        captured_under_a_profiler):
    """What ``tally`` counts inside ``collected()`` is collected with or
    without a profiler; ``recount`` adds it to the totals once a call while
    one records, and never without one."""
    from torch.profiler import ProfilerActivity, profile

    from hyperpocket_tpu_torch.utils import profiling

    profiling.reset()
    try:
        with (profile(activities=[ProfilerActivity.CPU]) if captured_under_a_profiler
              else contextlib.nullcontext()):
            with profiling.collected() as counts:
                profiling.tally("adam_lowp.values", 41)
                profiling.tally("encoder.trunk_route.k8")
                profiling.tally("encoder.trunk_route.k8")
        assert counts == {"adam_lowp.values": 41, "encoder.trunk_route.k8": 2}
        captured = int(captured_under_a_profiler)
        want = {} if not captured else {"adam_lowp.values": (41, 0.0),
                                        "encoder.trunk_route.k8": (2, 0.0)}
        assert profiling.totals() == want
        profiling.recount(counts)
        assert profiling.totals() == want
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(3):
                profiling.recount(counts)
        assert profiling.totals() == {"adam_lowp.values": (41 * (3 + captured), 0.0),
                                      "encoder.trunk_route.k8": (2 * (3 + captured), 0.0)}
        profiling.tally("adam_lowp.values", 5)  # no collection open, no profiler
        assert profiling.totals()["adam_lowp.values"] == (41 * (3 + captured), 0.0)
    finally:
        profiling.reset()


def test_upload_stacked_keeps_values_and_dtypes():
    rng = np.random.default_rng(0)
    parts = [[rng.standard_normal((2, 5, 3)).astype(np.float32) for _ in range(3)],
             [rng.standard_normal((2, 7, 3)) for _ in range(3)],
             [rng.integers(0, 9, (4,), dtype=np.int32) for _ in range(3)]]
    got = upload_stacked(parts, torch.device("cpu"))
    for g, p in zip(got, parts):
        want = np.stack(p)
        assert g.dtype == torch.from_numpy(want).dtype and np.array_equal(g.numpy(), want)


@pytest.fixture(scope="module")
def gloo_runs(data_root, tmp_path_factory):
    """Trainers on one gloo group of two ranks (fp64, two epochs of 3 batches
    of 2 global rows), scan and step, at data=2 and at model=2."""
    out = tmp_path_factory.mktemp("gloo")
    cfg = _config(data_root, out / "runs", "step", saves=True)
    cfgs = {(mode, n_model): {**cfg, "results_root": str(out / f"{mode}{n_model}")}
            for mode in ("step", "scan") for n_model in (1, 2)}
    spawn([("trainer_run", dict(config=c, tag=f"{mode}{n_model}", n_model=n_model,
                                epoch_mode=mode))
           for (mode, n_model), c in cfgs.items()], 2, out)
    return out, cfgs


@pytest.mark.parametrize("n_model", [1, 2])
def test_scan_under_a_gloo_mesh_of_two_matches_the_step_loop(gloo_runs, n_model):
    """Data-parallel (one row of each batch a rank; the val epoch sharded
    where its batch divides) and tensor-parallel (the hypernetwork's
    trunk[-1] and head split): the scanned run is the step loop's, bit for
    bit, down to the saved files."""
    out, cfgs = gloo_runs
    got = {m: np.load(out / f"trainer_{m}{n_model}.npz") for m in ("step", "scan")}
    np.testing.assert_array_equal(got["scan"]["scan_counts"], [EPOCHS, EPOCHS])
    np.testing.assert_array_equal(got["step"]["scan_counts"], [0, 0])
    np.testing.assert_array_equal(got["scan"]["mesh"], [2 // n_model, n_model])
    for key in ("rows", "train", "val", "seed_counter"):
        assert np.array_equal(got["scan"][key], got["step"][key]), key
    assert got["scan"]["rows"].shape == (EPOCHS * 3, 3)
    weights = {m: join(get_results_dir_path(cfgs[m, n_model], "training"), "weights")
               for m in ("step", "scan")}
    for name in (f"{EPOCHS:05}_model.npz", f"{EPOCHS:05}_O.npz"):
        with np.load(join(weights["scan"], name)) as a, np.load(join(weights["step"], name)) as b:
            assert a.files == b.files
            for f in a.files:
                assert np.array_equal(a[f], b[f]), (name, f)


@pytest.mark.parametrize("drop_last", [True, False])
def test_jax_and_port_scan_alike(data_root, tmp_path, drop_last):
    """The JAX Trainer and the port's, in scan mode on one corpus and config:
    the same scanned epochs and categories and loss-row shapes."""
    from hyperpocket_tpu.train.trainer import Trainer as JaxTrainer

    shapes = {}
    for name in ("jax", "port"):
        cfg = _config(data_root, tmp_path / name, "scan", "float32", drop_last)
        t = (JaxTrainer(cfg, use_mesh=False) if name == "jax"
             else trainer.Trainer(cfg, device="cpu"))
        rows = []
        for epoch in range(1, EPOCHS + 1):
            t.train_epoch(epoch)
            rows.append(np.asarray(t.last_step_losses).shape)
            t.val_epoch(epoch)
        shapes[name] = (rows, t.scan_invocations, t.val_scan_invocations)
    assert shapes["port"] == shapes["jax"]
    assert shapes["port"][1:] == (EPOCHS, EPOCHS)
