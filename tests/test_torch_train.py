"""Port's training path (hyperpocket_tpu_torch/train) vs the JAX package.

Weights go across with ``convert.params_from_jax`` and come back with
``params_to_jax``; both sides get the same numpy inputs, VAE noise and ball
points. The training forward and every parameter gradient are held to the
fp32 parity budget (1e-5, relative to each tensor's largest magnitude).
In bf16 the two frameworks round at other places (XLA on the CPU keeps
excess fp32 precision inside fused ops), and the encoders' max-pool has
ties in bf16 that route a gradient to another point: outputs are held to
5% of their largest magnitude, gradients to 10% relative L2 over all
parameters and 30% for each tensor (the JAX package's own bf16 gradients of
the first encoder layer lie 21% from its fp32 ones on these inputs). The
optimizers are held to optax in fp64. Five train steps are held to the JAX
train step in fp64 (1e-9 per step) and, in fp32, to the step-0 loss (1e-6)
and an envelope after it, as in tests/test_reference_parity.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hyperpocket_tpu.models import full_model as jfm
from hyperpocket_tpu.train import losses as jlosses
from hyperpocket_tpu.train import optim as joptim
from hyperpocket_tpu.train import trainer as jtrainer
from hyperpocket_tpu_torch.convert import params_from_jax, params_to_jax
from hyperpocket_tpu_torch.models import full_model as pfm
from hyperpocket_tpu_torch.models.full_model import (
    MODE_HYPER_CLOUD,
    MODE_HYPER_POCKET,
    MODE_HYPER_REC,
    FullModel,
)
from hyperpocket_tpu_torch.train import optim, trainer
from hyperpocket_tpu_torch.train.losses import kld_loss, reconstruction_loss
from tests.test_torch_models import model_pair, tiny_config

torch.set_float32_matmul_precision("highest")

B, N_PART, N_OUT = 2, 1024, 128  # N_PART >= 2 * 512: the encoders' sparse max-pool
FP32_TOL = 1e-5
BF16_TOL = 0.05
BF16_GRAD_TOTAL, BF16_GRAD_EACH = 0.1, 0.3


def _train_inputs(model, seed: int = 0, n_part: int = N_PART, n_out: int = N_OUT,
                  batch: int = B) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    z = max(model.get_noise_size(), 1)
    return {
        "existing": rng.standard_normal((batch, n_part, 3)).astype(np.float32) * 0.3,
        "missing": rng.standard_normal((batch, n_part, 3)).astype(np.float32) * 0.3,
        "gt": rng.standard_normal((batch, n_out, 3)).astype(np.float32) * 0.3,
        "vae_eps": rng.standard_normal((batch, z)).astype(np.float32),
        "ball_points": rng.uniform(-0.5, 0.5, (batch, n_out, 3)).astype(np.float32),
    }


def _jax_loss_and_grads(jmodel, params, data):
    def loss_fn(p):
        rec, mu, sigma = jmodel.apply(
            p, jnp.asarray(data["existing"]), jnp.asarray(data["missing"]), jax.random.key(1),
            jnp.asarray(1.0), num_output_points=N_OUT, training=True,
            vae_eps=jnp.asarray(data["vae_eps"]), ball_points=jnp.asarray(data["ball_points"]))
        loss = jlosses.reconstruction_loss(jnp.asarray(data["gt"]), rec, 0.05)
        if jmodel.has_generativity:
            loss = loss + jlosses.kld_loss(mu, sigma, B)
        return loss, (rec, mu, sigma)

    (loss, outs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return float(loss), outs, params_from_jax(jax.device_get(grads))


def _port_loss_and_grads(port, data):
    t = {k: torch.from_numpy(v) for k, v in data.items()}
    port.zero_grad(set_to_none=True)
    rec, mu, sigma = port.apply(t["existing"], t["missing"], None, 1.0, num_output_points=N_OUT,
                                training=True, vae_eps=t["vae_eps"],
                                ball_points=t["ball_points"])
    loss = reconstruction_loss(t["gt"], rec, 0.05)
    if port.has_generativity:
        loss = loss + kld_loss(mu, sigma, B)
    loss.backward()
    grads = {n: p.grad for n, p in port.named_parameters()}
    return loss.item(), (rec, mu, sigma), grads


def _close(got: np.ndarray, want: np.ndarray, tol: float, what: str) -> None:
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: max |port - jax| / max |jax| = {err} > {tol}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", [MODE_HYPER_POCKET, MODE_HYPER_REC, MODE_HYPER_CLOUD])
def test_training_forward_and_gradients_match_jax(mode, dtype):
    jmodel, params, port = model_pair(tiny_config(mode, compute_dtype=dtype))
    assert port.has_generativity == jmodel.has_generativity
    data = _train_inputs(port)
    want_loss, want_outs, want_grads = _jax_loss_and_grads(jmodel, params, data)
    got_loss, got_outs, got_grads = _port_loss_and_grads(port, data)
    rec = got_outs[0]
    assert rec.shape == (B, N_OUT, 3) and rec.dtype == torch.float32 and rec.requires_grad
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    assert abs(got_loss - want_loss) <= tol * abs(want_loss)
    for name, got, want in zip(("rec", "mu", "sigma"), got_outs, want_outs):
        assert (got is None) == (want is None), name
        if got is not None:
            assert got.dtype == torch.float32
            _close(got.detach().numpy(), np.asarray(want, np.float32), tol, name)
    assert got_grads.keys() == want_grads.keys()
    diff2 = norm2 = 0.0
    for name, want in want_grads.items():
        got = got_grads[name]
        if got is None:  # a parameter off the loss's path: JAX's gradient is zero there
            assert not want.any(), name
            continue
        assert got.dtype == torch.float32, name
        if dtype == "float32":
            _close(got.numpy(), want.numpy(), FP32_TOL, name)
        else:
            rel_l2 = (got - want).norm() / want.norm().clamp_min(1e-30)
            assert rel_l2 <= BF16_GRAD_EACH, f"{name}: relative L2 {rel_l2}"
            diff2 += float((got - want).norm() ** 2)
            norm2 += float(want.norm() ** 2)
    assert diff2 <= BF16_GRAD_TOTAL ** 2 * norm2


def test_frozen_heads_get_no_gradient_and_no_update():
    cfg = tiny_config()
    cfg["target_network"] = {**cfg["target_network"], "freeze_layers_learning": True}
    _, _, port = model_pair(cfg)
    heads = [p for n, p in port.named_parameters() if n.startswith("hyper_network.heads.")]
    trainable = optim.trainable_parameters(port)
    assert len(trainable) == len(list(port.parameters())) - 2
    assert not any(p is h for p in trainable for h in heads)
    opt = optim.make_optimizer({"type": "Adam", "hyperparams": {"lr": 1e-3}}, trainable)
    before = [p.detach().clone() for p in port.parameters()]
    data = {k: torch.from_numpy(v) for k, v in _train_inputs(port, n_part=64).items()}
    step = trainer.make_train_step(port, opt, 0.05)
    loss, loss_r, loss_k, rec = step(data["existing"], data["missing"], data["gt"], None, 1.0,
                                     N_OUT, vae_eps=data["vae_eps"],
                                     ball_points=data["ball_points"])
    assert all(h.grad is None for h in heads)
    for (name, p), old in zip(port.named_parameters(), before):
        if name.startswith("hyper_network.heads."):
            assert torch.equal(p, old), name
        elif p.grad is not None and p.grad.any():
            assert not torch.equal(p, old), name
    assert torch.isfinite(loss) and loss.item() == pytest.approx(loss_r.item() + loss_k.item())


def test_params_to_jax_inverts_params_from_jax():
    jmodel, params, port = model_pair(tiny_config())
    tree = params_to_jax(port)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(params)
    for got, want in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(got, np.asarray(want))
    state = params_from_jax(tree)
    assert all(torch.equal(state[n], t) for n, t in port.state_dict().items())
    assert params_from_jax(tree, torch.float64)["hyper_network.heads.weight"].dtype == torch.float64


# ---------------------------------------------------------------------------
# Optimizers and schedules against optax, fp64

OPTIMIZERS = {
    "adam": {"type": "Adam", "hyperparams": {"lr": 1e-3, "betas": [0.9, 0.99]}},
    "adam_l2": {"type": "Adam", "hyperparams": {"lr": 1e-3, "weight_decay": 0.05}},
    "adam_amsgrad": {"type": "Adam", "hyperparams": {"lr": 1e-3, "amsgrad": True,
                                                     "weight_decay": 0.05}},
    "adamw": {"type": "AdamW", "hyperparams": {"lr": 1e-3, "weight_decay": 0.05, "eps": 1e-6}},
    "adamw_amsgrad": {"type": "AdamW", "hyperparams": {"lr": 1e-3, "weight_decay": 0.05,
                                                       "amsgrad": True}},
    "sgd": {"type": "SGD", "hyperparams": {"lr": 1e-2}},
    "sgd_momentum": {"type": "SGD", "hyperparams": {"lr": 1e-2, "momentum": 0.9,
                                                    "weight_decay": 0.01}},
    "sgd_nesterov": {"type": "SGD", "hyperparams": {"lr": 1e-2, "momentum": 0.9,
                                                    "nesterov": True}},
    "rmsprop": {"type": "RMSprop", "hyperparams": {"lr": 1e-3, "alpha": 0.9, "eps": 1e-4}},
    "rmsprop_l2": {"type": "RMSprop", "hyperparams": {"lr": 1e-3, "weight_decay": 0.05}},
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_steps_match_optax_fp64(name):
    cfg = OPTIMIZERS[name]
    rng = np.random.default_rng(8)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    params0 = [rng.standard_normal(s) for s in shapes]
    # gradients that shrink after the first step, so AMSGrad's running max matters
    grads = [[rng.standard_normal(s) * scale for s in shapes] for scale in (1.0, 0.1, 0.5)]
    with jax.enable_x64(True):
        tx = joptim.make_optimizer(cfg)
        jparams = [jnp.asarray(p) for p in params0]
        state = tx.init(jparams)
        want = []
        for g in grads:
            updates, state = tx.update([jnp.asarray(a) for a in g], state, jparams)
            jparams = optax.apply_updates(jparams, updates)
            want.append([np.asarray(p) for p in jparams])
    tparams = [torch.tensor(p, requires_grad=True) for p in params0]
    opt = optim.make_optimizer(cfg, tparams)
    for step, g in enumerate(grads):
        for p, a in zip(tparams, g):
            p.grad = torch.tensor(a)
        opt.step()
        for p, w in zip(tparams, want[step]):
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-12, atol=1e-14)


def test_moment_dtype_is_not_ported_yet():
    p = [torch.zeros(2, requires_grad=True)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        optim.make_optimizer({"type": "Adam", "hyperparams": {"moment_dtype": "bfloat16"}}, p)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        optim.make_optimizer({"type": "Adam", "hyperparams": {"amsgrad": True}}, p,
                             moment_dtype="bfloat16")
    with pytest.raises(ValueError, match="unsupported optimizer"):
        optim.make_optimizer({"type": "Adagrad"}, p)


@pytest.mark.parametrize("sched", [
    None,
    {"type": "StepLR", "hyperparams": {"step_size": 3, "gamma": 0.5}},
    {"type": "MultiStepLR", "hyperparams": {"milestones": [2, 5], "gamma": 0.1}},
    {"type": "ExponentialLR", "hyperparams": {"gamma": 0.9}},
    {"type": "CosineAnnealingLR", "hyperparams": {"T_max": 6, "eta_min": 1e-5}},
    {"type": "ConstantLR"},
])
def test_lr_schedule_and_set_learning_rate_match_jax(sched):
    got = optim.make_lr_schedule(sched, 1e-3)
    want = joptim.make_lr_schedule(sched, 1e-3)
    assert [got(e) for e in range(1, 10)] == [want(e) for e in range(1, 10)]
    opt = optim.make_optimizer({"type": "Adam"}, [torch.zeros(2, requires_grad=True)])
    assert optim.set_learning_rate(opt, got(7)) is opt
    assert all(g["lr"] == want(7) for g in opt.param_groups)


def test_model_from_config_takes_the_training_compute_dtype():
    config = {"full_model": tiny_config(), "training": {"compute_dtype": "bfloat16"}}
    assert trainer.model_from_config(config).compute_dtype == "bfloat16"
    config["full_model"]["compute_dtype"] = "float32"
    assert trainer.model_from_config(config).compute_dtype == "float32"
    assert trainer.model_from_config({"full_model": tiny_config()}).compute_dtype == "float32"


def test_matmul_precision_highest_turns_tf32_off():
    try:
        trainer.set_matmul_precision("high")
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        trainer.set_matmul_precision("highest")
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        trainer.set_matmul_precision("highest")


# ---------------------------------------------------------------------------
# Five train steps, and the val step, against the JAX package
# (the tiny configuration of tests/test_reference_parity.py)

_K, _TB, _N_EX, _N_GT, _Z = 5, 4, 128, 256, 32
_OUT = [32, 64, 128, 64]
_ADAM = {"type": "Adam", "hyperparams": {"lr": 1e-4, "weight_decay": 0, "betas": [0.9, 0.999],
                                         "amsgrad": False}}


def _traj_config(compute_dtype: str) -> dict:
    enc = {"output_size": _Z, "use_bias": True, "relu_slope": 0.2}
    return {
        "random_encoder": dict(enc), "real_encoder": dict(enc),
        "hyper_network": {"use_bias": True, "relu_slope": 0.2},
        "target_network": {"use_bias": True, "relu_slope": 0.2,
                           "freeze_layers_learning": False, "layer_out_channels": _OUT},
        "target_network_input": {"constant": False,
                                 "normalization": {"enable": False, "type": "progressive",
                                                   "epoch": 100}},
        "compute_dtype": compute_dtype,
    }


def _traj_data(seed: int = 11):
    rng = np.random.default_rng(seed)
    existing = (rng.standard_normal((_K, _TB, _N_EX, 3)) * 0.3).astype(np.float32)
    missing = (rng.standard_normal((_K, _TB, _N_EX, 3)) * 0.3).astype(np.float32)
    gt = (rng.standard_normal((_K, _TB, _N_GT, 3)) * 0.3).astype(np.float32)
    eps = rng.standard_normal((_K, _TB, _Z)).astype(np.float32)
    dirs = rng.standard_normal((_K, _TB, _N_GT, 3)).astype(np.float32)
    dirs /= np.maximum(np.linalg.norm(dirs, axis=-1, keepdims=True), 1e-9)
    radii = rng.uniform(size=(_K, _TB, _N_GT, 1)).astype(np.float32) ** (1 / 3)
    return existing, missing, gt, eps, (dirs * radii).astype(np.float32)


def _trajectories(dtype: str):
    """K steps of both packages from the same weights: (jax losses, port losses,
    jax final params, port final params as the JAX tree)."""
    existing, missing, gt, eps, balls = _traj_data()
    cfg = _traj_config(dtype)
    jmodel = jfm.FullModel.from_config(cfg)
    jdtype = jnp.float64 if dtype == "float64" else jnp.float32
    params = jmodel.init(jax.random.key(77), dtype=jdtype)
    tx = joptim.make_optimizer(_ADAM)
    opt_state = tx.init(params)
    tdtype = torch.float64 if dtype == "float64" else torch.float32
    port = FullModel.from_config(cfg).to(tdtype)  # load_state_dict copies into this dtype
    port.load_state_dict(params_from_jax(jax.device_get(params), tdtype))
    # copy: the JAX step donates its params
    params = jax.tree_util.tree_map(jnp.array, params)
    jstep = jtrainer.make_train_step(jmodel, tx, 0.05)
    pstep = trainer.make_train_step(port, optim.make_optimizer(_ADAM, port.parameters()), 0.05)
    want, got = [], []
    for k in range(_K):
        params, opt_state, *losses, _ = jstep(
            params, opt_state, jnp.asarray(existing[k]), jnp.asarray(missing[k]),
            jnp.asarray(gt[k]), np.uint32(k), jnp.asarray(1.0), num_points=_N_GT,
            vae_eps=jnp.asarray(eps[k]), ball_points=jnp.asarray(balls[k]))
        want.append([float(v) for v in losses])
        t = [torch.from_numpy(a[k]) for a in (existing, missing, gt, eps, balls)]
        out = pstep(t[0], t[1], t[2], None, 1.0, _N_GT, vae_eps=t[3], ball_points=t[4])
        got.append([v.item() for v in out[:3]])
    return np.asarray(want), np.asarray(got), jax.device_get(params), params_to_jax(port)


def test_train_step_trajectory_fp64_matches_jax():
    with jax.enable_x64(True):
        want, got, jparams, pparams = _trajectories("float64")
    rel = np.abs(got - want) / np.abs(want)
    assert rel[:, :2].max() <= 1e-9, f"per-step (loss, loss_r) relative difference {rel}"
    assert np.abs(got[:, 2] - want[:, 2]).max() <= 1e-9 * np.abs(want[:, 2]).max()
    for j, p in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(pparams)):
        assert p.dtype == np.float64
        assert np.abs(p - j).max() <= 1e-8 * max(np.abs(j).max(), 1e-30)
    assert got[-1, 0] < got[0, 0]


def test_train_step_trajectory_fp32_envelope():
    """fp32: K1's plain version on the port side, the Pallas kernel in interpret
    mode on the JAX side; Adam's first update is lr * sign(g), so gradients at the
    rounding floor diverge chaotically after step 0 (see test_reference_parity)."""
    want, got, _, _ = _trajectories("float32")
    rel = np.abs(got[:, 0] - want[:, 0]) / np.abs(want[:, 0])
    assert rel[0] <= 1e-6, f"step-0 loss relative difference {rel[0]}"
    assert rel.max() <= 2e-2, f"fp32 divergence envelope exceeded: {rel}"
    assert got[-1, 0] < got[0, 0] and want[-1, 0] < want[0, 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_val_step_matches_jax(dtype, monkeypatch):
    """The JAX val step draws its ball points from its key: both sides are handed
    the same points through their sampler."""
    jmodel, params, port = model_pair(tiny_config(compute_dtype=dtype))
    data = _train_inputs(port, seed=9, n_part=64, n_out=256)
    balls = data["ball_points"]
    monkeypatch.setattr(jfm, "generate_target_network_input_batch",
                        lambda *a, **k: jnp.asarray(balls))
    monkeypatch.setattr(pfm, "generate_target_network_input_batch",
                        lambda *a, **k: torch.from_numpy(balls))
    jstep = jtrainer.make_val_step(jmodel, 0.05)
    want_loss, want_rec = jstep(params, jnp.asarray(data["existing"]),
                                jnp.asarray(data["missing"]), jnp.asarray(data["gt"]),
                                np.uint32(3), jnp.asarray(1.0), num_points=256)
    t = {k: torch.from_numpy(v) for k, v in data.items()}
    step = trainer.make_val_step(port, 0.05)
    got_loss, got_rec = step(t["existing"], t["missing"], t["gt"],
                             torch.Generator().manual_seed(3), 1.0, 256)
    assert not got_loss.requires_grad and got_rec.dtype == torch.float32
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    assert abs(got_loss.item() - float(want_loss)) <= tol * abs(float(want_loss))
    _close(got_rec.numpy(), np.asarray(want_rec, np.float32), tol, "rec")
