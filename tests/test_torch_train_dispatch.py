"""The training path's dispatch in the port, on the CPU: the Chamfer route
(``ops/nn.py::chamfer_grad_route``) and the bf16-moment Adam's per-tensor
update (``ops/adam_lowp.py``) against the JAX package's ``scale_by_adam_lowp``
and against ``AdamLowp``'s loop as it was before the update had a kernel.

The route is decided from device type, dtype, point counts and whether a
gradient is needed, so a CUDA cloud is stood for by an object with those
attributes and nothing is launched.
"""

from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hyperpocket_tpu.train import optim as joptim
from hyperpocket_tpu_torch.ops import nn as nn_ops
from hyperpocket_tpu_torch.ops.adam_lowp import adam_lowp_update, adam_lowp_update_reference
from hyperpocket_tpu_torch.ops.chamfer import chamfer_loss
from hyperpocket_tpu_torch.train import optim, trainer
from tests.test_data import make_synthetic_shapenet
from tests.test_train_integration import make_config


def _cloud(device: str, dtype, n: int, grad: bool):
    """An object with what the route reads of a (4, n, 3) cloud."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype, shape=(4, n, 3),
                                 requires_grad=grad)


@pytest.fixture
def deterministic_algorithms():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(before)


@pytest.mark.parametrize("device, dtype, n, m, grad, want", [
    ("cpu", torch.float32, 256, 128, True, "streaming"),  # the JAX package's 128 gate
    ("cpu", torch.float32, 256, 128, False, "streaming"),
    ("cpu", torch.float32, 200, 128, True, "plain"),
    ("cpu", torch.float32, 256, 100, True, "plain"),
    ("cpu", torch.float64, 256, 128, True, "plain"),  # the trajectory-parity mode
    ("cuda", torch.float32, 2048, 2048, True, "k9"),
    ("cuda", torch.float32, 2048, 1024, True, "k9"),
    ("cuda", torch.float32, 200, 136, True, "k9"),  # no 128 gate on the card
    ("cuda", torch.float32, 2048, 2048, False, "streaming"),  # K3 once
    ("cuda", torch.float64, 2048, 2048, True, "plain"),
    ("cuda", torch.bfloat16, 2048, 2048, True, "plain"),
])
def test_chamfer_grad_route(device, dtype, n, m, grad, want):
    gts = _cloud(device, dtype, n, False)
    preds = _cloud(device, dtype, m, grad)
    assert nn_ops.chamfer_grad_route(gts, preds) == want


@pytest.mark.parametrize("n, m, want", [(2048, 2048, "streaming"), (2048, 1024, "streaming"),
                                        (200, 136, "streaming")])
def test_chamfer_grad_route_under_deterministic_algorithms(deterministic_algorithms, n, m, want):
    """K9 scatters its gradients with fp32 atomics: the card's route is the
    streaming one, whose index_add_ torch makes deterministic here."""
    assert nn_ops.chamfer_grad_route(_cloud("cuda", torch.float32, n, False),
                                     _cloud("cuda", torch.float32, m, True)) == want
    assert nn_ops.chamfer_grad_route(_cloud("cpu", torch.float32, n, False),
                                     _cloud("cpu", torch.float32, m, True)) == (
        "streaming" if n % 128 == 0 and m % 128 == 0 else "plain")


def test_chamfer_grad_route_without_grad_mode():
    with torch.no_grad():
        assert nn_ops.chamfer_grad_route(_cloud("cuda", torch.float32, 2048, False),
                                         _cloud("cuda", torch.float32, 2048, True)) == "streaming"


@pytest.mark.parametrize("n, m, dtype, want", [(256, 128, torch.float32, "streaming"),
                                               (200, 136, torch.float32, "plain"),
                                               (256, 128, torch.float64, "plain")])
def test_chamfer_loss_auto_takes_the_route_on_the_cpu(n, m, dtype, want):
    """The CPU's routes are the JAX package's: value and gradient equal the
    plain loss's within the fp32 parity budget, and the route is recorded."""
    rng = np.random.default_rng(5)
    gts = torch.tensor(rng.standard_normal((2, n, 3)) * 0.3, dtype=dtype)
    preds = torch.tensor(rng.standard_normal((2, m, 3)) * 0.3, dtype=dtype, requires_grad=True)
    loss = nn_ops.chamfer_loss_auto(gts, preds)
    assert nn_ops.chamfer_loss_auto.route == want
    (grad,) = torch.autograd.grad(loss, preds)
    ref_preds = preds.detach().clone().requires_grad_()
    ref = chamfer_loss(gts, ref_preds)
    (ref_grad,) = torch.autograd.grad(ref, ref_preds)
    assert abs(loss.item() - ref.item()) <= 1e-5 * abs(ref.item())
    assert torch.allclose(grad, ref_grad, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("epoch_mode", ["step", "scan"])
def test_trainer_logs_the_chamfer_route_once(tmp_path, epoch_mode):
    """Each Trainer logs the route its train steps took, once, to its
    ``log.txt``: on the CPU at fp32 and 128 points the JAX package's
    streaming route."""
    from pathlib import Path

    make_synthetic_shapenet(tmp_path / "data", n_models=4)
    cfg = make_config(tmp_path / "data", tmp_path / "results")
    cfg["training"]["epoch_mode"] = epoch_mode
    t = trainer.Trainer(cfg, device="cpu")
    t.train_epoch(1)
    t.train_epoch(2)
    log = (Path(t.result_dir) / "log.txt").read_text()
    assert [line.split(" ", 2)[2] for line in log.splitlines() if "Chamfer route" in line] == [
        "training loss: Chamfer route 'streaming' (deterministic algorithms False)"]


# ---------------------------------------------------------------------------
# adam_lowp_update's plain version against the JAX package's optimizer


def _jax_chain(kind: str, lr: float, wd: float, moment_dtype: str):
    """``scale_by_adam_lowp`` chained with the decay and ``-lr`` as the JAX
    package's ``make_optimizer`` chains them: coupled decay before the
    moments (Adam), decoupled after them (AdamW)."""
    parts = []
    if kind == "Adam" and wd:
        parts.append(optax.add_decayed_weights(wd))
    parts.append(joptim.scale_by_adam_lowp(0.9, 0.999, 1e-8, moment_dtype))
    if kind == "AdamW" and wd:
        parts.append(optax.add_decayed_weights(wd))
    parts.append(optax.scale(-lr))
    return optax.chain(*parts), int(kind == "Adam" and bool(wd))


@pytest.mark.parametrize("moment_dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("kind", ["Adam", "AdamW"])
@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_adam_lowp_reference_matches_scale_by_adam_lowp(moment_dtype, kind, wd):
    """Three steps of ``adam_lowp_update_reference`` (through ``AdamLowp``)
    against the JAX chain: moments bit for bit, the update within rtol 1e-6."""
    rng = np.random.default_rng(11)
    shapes = [(6, 5), (7,), (3, 4, 2)]
    params0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
             for scale in (1.0, 0.1, 2.0)]
    lr = 1.0  # the update is the parameter's change
    tx, adam_at = _jax_chain(kind, lr, wd, moment_dtype)
    jparams = [jnp.asarray(p) for p in params0]
    state = tx.init(jparams)
    tparams = [torch.tensor(p, requires_grad=True) for p in params0]
    opt = optim.make_optimizer({"type": kind, "hyperparams": {
        "lr": lr, "weight_decay": wd, "moment_dtype": moment_dtype}}, tparams)
    assert isinstance(opt, optim.AdamLowp)
    for g in grads:
        updates, state = tx.update([jnp.asarray(a) for a in g], state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = [p.detach().clone() for p in tparams]
        for p, a in zip(tparams, g):
            p.grad = torch.tensor(a)
        opt.step()
        adam_state = state[adam_at]
        for i, p in enumerate(tparams):
            st = opt.state[p]
            assert np.array_equal(st["mu"].float().numpy(),
                                  np.asarray(jnp.asarray(adam_state.mu[i], jnp.float32)))
            assert np.array_equal(st["nu"].float().numpy(),
                                  np.asarray(jnp.asarray(adam_state.nu[i], jnp.float32)))
            got_update = (p.detach() - before[i]).numpy()
            np.testing.assert_allclose(got_update, np.asarray(updates[i]), rtol=1e-6, atol=1e-7)


def _adam_lowp_step_before_the_kernel(opt: torch.optim.Optimizer) -> None:
    """``AdamLowp.step`` as it was written before its update moved to
    ``ops/adam_lowp.py``: the per-tensor torch arithmetic in the loop."""
    f32 = torch.float32
    with torch.no_grad():
        for group in opt.param_groups:
            b1, b2 = group["betas"]
            wd, md = group["weight_decay"], group["moment_dtype"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if wd and not group["decoupled"]:
                    g = g + wd * p
                state = opt.state[p]
                if not state:
                    state["step"] = optim.step_count(p)
                    state["mu"] = torch.zeros_like(p, dtype=md)
                    state["nu"] = torch.zeros_like(p, dtype=md)
                state["step"].add_(1)
                t = state["step"]
                mu = state["mu"].copy_(b1 * state["mu"].to(g.dtype) + (1 - b1) * g)
                nu = state["nu"].copy_(b2 * state["nu"].to(g.dtype) + (1 - b2) * g * g)
                bc1 = 1 - torch.full((), b1, dtype=f32, device=t.device) ** t
                bc2 = 1 - torch.full((), b2, dtype=f32, device=t.device) ** t
                update = (mu.to(f32) / bc1) / (torch.sqrt(nu.to(f32) / bc2) + group["eps"])
                if wd and group["decoupled"]:
                    update = update + wd * p
                p.add_((-group["lr"] * update).to(p.dtype))


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("moment_dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("kind, wd", [("Adam", 0.0), ("Adam", 0.05), ("AdamW", 0.05)])
def test_adam_lowp_equals_the_loop_before_the_kernel(param_dtype, moment_dtype, kind, wd):
    """The refactored ``AdamLowp`` and its former loop, three steps from the
    same start: parameters, moments and counts bit for bit."""
    rng = np.random.default_rng(21)
    shapes = [(9, 4), (5,), (2, 3, 7)]
    start = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 10.0 ** rng.integers(-4, 1, s)).astype(np.float32)
              for s in shapes] for _ in range(3)]
    cfg = {"type": kind, "hyperparams": {"lr": 1e-2, "weight_decay": wd,
                                         "moment_dtype": moment_dtype}}
    runs = []
    for old in (False, True):
        params = [torch.nn.Parameter(torch.tensor(p).to(param_dtype)) for p in start]
        opt = optim.make_optimizer(cfg, params)
        for step in grads:
            for p, g in zip(params, step):
                p.grad = torch.tensor(g).to(param_dtype)
            _adam_lowp_step_before_the_kernel(opt) if old else opt.step()
        runs.append([(p.detach(), opt.state[p]["mu"], opt.state[p]["nu"], opt.state[p]["step"])
                     for p in params])
    for new, old in zip(*runs):
        assert all(torch.equal(a, b) for a, b in zip(new, old))


def test_adam_lowp_update_takes_the_plain_version_on_the_cpu():
    """A CPU tensor runs the plain version and launches nothing."""
    before = adam_lowp_update.launches
    p, g = torch.randn(10), torch.randn(10)
    mu, nu = torch.zeros(10, dtype=torch.bfloat16), torch.zeros(10, dtype=torch.bfloat16)
    bc1, bc2 = torch.tensor(0.1), torch.tensor(0.001)
    want = [t.clone() for t in (p, mu, nu)]
    ref = adam_lowp_update_reference(want[0], g, want[1], want[2], bc1, bc2, lr=1e-3, b1=0.9,
                                     b2=0.999, eps=1e-8)
    got = adam_lowp_update(p, g, mu, nu, bc1, bc2, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    assert adam_lowp_update.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
