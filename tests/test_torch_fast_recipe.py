"""The fast training recipe (``settings/config_3depn_chair_fast.json``) on the
CPU: bf16 compute, ``AdamLowp`` with bf16 moments, through both trunk
routes, first against the JAX package's same recipe (bf16 compute,
``scale_by_adam_lowp``, K8 behind ``HPCD_TRUNK_FUSED_FWD``) on the same
weights and batches, then against the benchmark's plain fp32 reference
(``benchmark/reference/model.py``, TF32 off, fp32-moment Adam); the trunk's
route table; ``AdamLowp``'s state names and its checkpoint round trip.

The recipe runs at the published encoder and hypernetwork widths with a
small latent (16 + 16) and decoder (3-16-32-3), B=4, 1024 points a partial
cloud and a 1024-point ground truth, three steps from seeded weights
(``benchmark/inputs.py``). About a minute.
"""

from __future__ import annotations

import copy
import json
import statistics
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from benchmark import inputs
from benchmark.reference import model as ref
from benchmark.reference import quant
from hyperpocket_tpu.models import full_model as jfm
from hyperpocket_tpu.train import optim as joptim
from hyperpocket_tpu.train import trainer as jtrainer
from hyperpocket_tpu_torch.convert import params_from_jax, params_to_jax
from hyperpocket_tpu_torch.models import encoder as pencoder
from hyperpocket_tpu_torch.train import checkpoint as ckpt
from hyperpocket_tpu_torch.train import optim, trainer

ROOT = Path(__file__).resolve().parents[1]
FAST = json.loads((ROOT / "settings" / "config_3depn_chair_fast.json").read_text())
B, N_PARTIAL, N_GT, LATENT = 4, 1024, 1024, 16
STEPS = 3
SEEDS = (4, 6)

# bf16 keeps 8 significant bits: every product and activation of the step
# is rounded to ~0.4%, and the Chamfer sum over 8,192 pairs carries it. The
# first loss read 0.03-2.3% from the reference over 9 seeds, fp8 e4m3
# operands 8.5-23%.
LOSS1 = 0.05
# Adam's first steps move each weight by about the learning rate whatever
# its gradient's size, so rounding that turns a small gradient's sign moves
# the weight the other way: the second and third losses read up to 8.3%.
LOSS23 = 0.15
# The worst leaf of the first gradient's norm (the leaf's gap over the
# larger of its norm and the median leaf's): a small encoder bias sums few
# rounded products; 1.7-9.6% over 9 seeds.
GRAD1 = 0.15
# The worst leaf of the change after three steps: Adam's normalised update
# keeps only the gradient's direction, which bf16 moves by up to 7.5%; fp8
# reads in the same range, so this number does not tell the two apart.
DELTA3 = 0.12
DEAD_LEAF = 1e-3  # a reference gradient under this share of the median leaf's

# Against the JAX package, both sides in bf16: XLA's dots and torch's round
# the same bf16 products in other orders and at other points, a bf16 step
# (0.4%) here and there. Over 6 seeds and both routes: the first loss
# 0.017-0.56% apart (against the fp32 reference 0.03-2.3%); the first
# moments (bf16, (1 - b1) times the first gradient, compared value by value)
# 0.44-4.1% apart over all leaves and 8.0% at the worst leaf; the later
# losses up to 5.7% and the change's worst leaf norm 7.5%, where Adam's
# first steps (about lr x sign(g) a value) turn the signs of small gradients.
JAX_LOSS1 = 0.02
JAX_LOSS23 = 0.12
JAX_MU1, JAX_MU1_EACH = 0.1, 0.2
JAX_DELTA3 = 0.15


def fast_config() -> dict:
    cfg = copy.deepcopy(FAST)
    model = cfg["full_model"]
    model["random_encoder"]["output_size"] = LATENT
    model["real_encoder"]["output_size"] = LATENT
    model["target_network"]["layer_out_channels"] = [16, 32]
    return cfg


def make_steps(seed: int):
    """(config, weights, [(existing, missing, gt, vae eps, ball points)] x 3)."""
    cfg = fast_config()
    g = torch.Generator().manual_seed(seed)
    weights = inputs.make_weights(cfg["full_model"], seed, "cpu")
    steps = []
    for _ in range(STEPS):
        gt = torch.randn((B, N_GT, 3), generator=g) * 0.3
        existing = (gt[:, :N_PARTIAL] + 0.01 * torch.randn((B, N_PARTIAL, 3), generator=g))
        missing = gt[:, N_GT - N_PARTIAL:].contiguous()
        eps = torch.randn((B, LATENT), generator=g)
        balls = ref.ball_points(g, B, N_GT, 1.0, cfg["full_model"]["target_network_input"])
        steps.append((existing.contiguous(), missing, gt, eps, balls))
    return cfg, weights, steps


def program_steps(cfg, weights, steps):
    """The port's train steps: (losses, first gradient, first moment after
    step 1 in fp32, change), tensors by leaf."""
    model = trainer.model_from_config(cfg)
    assert model.compute_dtype == "bfloat16"
    named = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(weights[name])
    opt = optim.make_optimizer(cfg["training"]["optimizer"], optim.trainable_parameters(model))
    assert isinstance(opt, optim.AdamLowp)
    step = trainer.make_train_step(model, opt, float(cfg["training"]["loss_coef"]))
    losses, grad1, mu1 = [], None, None
    for k, (existing, missing, gt, eps, balls) in enumerate(steps):
        loss, _, _, _ = step(existing, missing, gt, None, 1.0, N_GT, vae_eps=eps,
                             ball_points=balls)
        losses.append(float(loss))
        if k == 0:
            grad1 = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                     for n, p in named.items()}
            mu1 = {n: opt.state[p]["exp_avg"].float() if p in opt.state else torch.zeros_like(p)
                   for n, p in named.items()}
    assert all(s["exp_avg"].dtype == torch.bfloat16 for s in opt.state.values())
    return losses, grad1, mu1, {n: p.detach() - weights[n] for n, p in named.items()}


def program(cfg, weights, steps):
    """The port's train steps: (losses, first gradient's leaf norms, change's leaf norms)."""
    losses, grad1, _, delta = program_steps(cfg, weights, steps)
    return (losses, {n: float(g.norm()) for n, g in grad1.items()},
            {n: float(d.norm()) for n, d in delta.items()})


def jax_package(cfg, weights, steps):
    """The JAX package's train steps of the same recipe from the same
    weights: (losses, first moment after step 1 in fp32, change), by leaf.
    ``HPCD_TRUNK_FUSED_FWD`` is read as the step is traced."""
    port = trainer.model_from_config(cfg)
    with torch.no_grad():
        for name, p in port.named_parameters():
            p.copy_(weights[name])
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(port))
    model_cfg = dict(cfg["full_model"], compute_dtype=cfg["training"]["compute_dtype"])
    tx = joptim.make_optimizer(cfg["training"]["optimizer"])
    state = tx.init(params)
    step = jtrainer.make_train_step(jfm.FullModel.from_config(model_cfg), tx,
                                    float(cfg["training"]["loss_coef"]))
    losses, mu1 = [], None
    for k, (existing, missing, gt, eps, balls) in enumerate(steps):
        params, state, loss, _, _, _ = step(
            params, state, *(jnp.asarray(t.numpy()) for t in (existing, missing, gt)),
            np.uint32(k), jnp.asarray(1.0), num_points=N_GT, vae_eps=jnp.asarray(eps.numpy()),
            ball_points=jnp.asarray(balls.numpy()))
        losses.append(float(loss))
        if k == 0:
            adam, = [s for s in jax.tree_util.tree_leaves(
                state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
                if isinstance(s, optax.ScaleByAdamState)]
            assert all(m.dtype == jnp.bfloat16 for m in jax.tree_util.tree_leaves(adam.mu))
            mu1 = params_from_jax(jax.tree_util.tree_map(
                lambda m: np.asarray(m, np.float32), jax.device_get(adam.mu)))
    final = params_from_jax(jax.device_get(params))
    return losses, mu1, {n: final[n] - weights[n] for n in weights}


def reference(cfg, weights, steps, q=None):
    """The plain reference's steps (fp32, TF32 off, fp32-moment Adam), its
    products rounded by ``q`` for a control."""
    params = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    hp = cfg["training"]["optimizer"]["hyperparams"]
    adam = ref.Adam(params, float(hp["lr"]), tuple(hp["betas"]))
    losses, grad1 = [], None
    with ref.fp32_highest():
        for k, (existing, missing, gt, eps, balls) in enumerate(steps):
            loss, _, _ = ref.train_loss(params, cfg["full_model"], existing, missing, gt, eps,
                                        balls, float(cfg["training"]["loss_coef"]), q)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            grads = {n: torch.zeros_like(v) if g is None else g  # the real encoder's std head
                     for (n, v), g in zip(params.items(), grads)}
            if k == 0:
                grad1 = {n: float(g.norm()) for n, g in grads.items()}
            adam.step(params, grads)
            losses.append(float(loss.detach()))
    return losses, grad1, {n: float((v.detach() - weights[n]).norm()) for n, v in params.items()}


def gaps(got, want) -> dict:
    """Each step's loss gap, and the worst leaf of the first gradient and of
    the change (the change over the leaves the reference's gradient moves)."""
    def worst(a, b, leaves):
        floor = statistics.median(b[n] for n in leaves)
        return max(abs(a[n] - b[n]) / max(b[n], floor, 1e-30) for n in leaves)

    leaves = sorted(want[1])
    median = statistics.median(want[1][n] for n in leaves)
    moved = [n for n in leaves if want[1][n] >= DEAD_LEAF * median]
    return {"loss": [abs(a - b) / abs(b) for a, b in zip(got[0], want[0])],
            "grad1": worst(got[1], want[1], leaves), "delta3": worst(got[2], want[2], moved)}


def within(g: dict) -> dict:
    return {"loss1": g["loss"][0] <= LOSS1, "loss23": max(g["loss"][1:]) <= LOSS23,
            "grad1": g["grad1"] <= GRAD1, "delta3": g["delta3"] <= DELTA3}


@pytest.fixture(scope="module", params=SEEDS)
def recipe(request):
    cfg, weights, steps = make_steps(request.param)
    return cfg, weights, steps, reference(cfg, weights, steps)


def _route(monkeypatch, route: str) -> None:
    if route == "k8":
        monkeypatch.setenv("HPCD_TRUNK_FUSED_FWD", "1")
    else:
        monkeypatch.delenv("HPCD_TRUNK_FUSED_FWD", raising=False)


@pytest.mark.parametrize("route", ["sparse", "k8"])
def test_the_fast_recipe_steps_agree_with_the_jax_package(recipe, monkeypatch, route):
    """The JAX package's three steps with its opt-in off (the sparse
    backward's chain) against the port's sparse route, and on (the Pallas
    K8 in interpret mode) against K8's plain version: losses, the bf16 first
    moments value by value, and the change's leaf norms."""
    cfg, weights, steps, _ = recipe
    _route(monkeypatch, route)
    assert pencoder.trunk_grad_route(steps[0][0].to(torch.bfloat16)) == route
    want_losses, want_mu1, want_delta = jax_package(cfg, weights, steps)
    losses, _, mu1, delta = program_steps(cfg, weights, steps)
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, want_losses)]
    assert loss_gaps[0] <= JAX_LOSS1 and max(loss_gaps[1:]) <= JAX_LOSS23, loss_gaps
    moved = [n for n, m in want_mu1.items() if m.norm() > 0]  # not the real encoder's std head
    assert set(want_mu1) - set(moved) == {"real_encoder.std.weight", "real_encoder.std.bias"}
    each = {n: float((mu1[n] - want_mu1[n]).norm() / want_mu1[n].norm()) for n in moved}
    total = float(sum((mu1[n] - want_mu1[n]).norm() ** 2 for n in moved) ** 0.5
                  / sum(want_mu1[n].norm() ** 2 for n in moved) ** 0.5)
    assert total <= JAX_MU1 and max(each.values()) <= JAX_MU1_EACH, (total, each)
    floor = statistics.median(float(want_delta[n].norm()) for n in moved)
    worst = max(abs(float(delta[n].norm()) - float(want_delta[n].norm()))
                / max(float(want_delta[n].norm()), floor) for n in moved)
    assert worst <= JAX_DELTA3, worst


@pytest.mark.parametrize("route", ["sparse", "k8"])
def test_the_fast_recipe_steps_agree_with_the_fp32_reference(recipe, monkeypatch, route):
    """Both trunk routes of the bf16 step (the chain, and K8's plain version
    under the JAX package's opt-in), three steps with bf16 Adam moments."""
    cfg, weights, steps, want = recipe
    _route(monkeypatch, route)
    assert pencoder.trunk_grad_route(steps[0][0].to(torch.bfloat16)) == route
    g = gaps(program(cfg, weights, steps), want)
    assert all(within(g).values()), g


def test_fp8_operands_fall_outside_a_tolerance(recipe):
    """The control: the reference with every product's operands rounded to
    fp8 e4m3, the precision below bf16, is refused by a tolerance."""
    cfg, weights, steps, want = recipe
    g = gaps(reference(cfg, weights, steps, quant.fp8), want)
    assert not all(within(g).values()), g


def _cloud(device: str, dtype, n: int, b: int = 64):
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype, shape=(b, n, 3))


@pytest.mark.parametrize("device, dtype, n, grad, env, route", [
    ("cuda", torch.bfloat16, 1024, True, None, "k8"),
    ("cuda", torch.bfloat16, 2048, True, None, "k8"),
    ("cuda", torch.bfloat16, 1024, True, "0", "k8"),  # the card reads no variable
    ("cuda", torch.float32, 1024, True, "1", "sparse"),
    ("cuda", torch.bfloat16, 512, True, None, "chain"),
    ("cuda", torch.bfloat16, 1028, True, None, "sparse"),  # N % 8 != 0
    ("cuda", torch.bfloat16, 1024, False, None, "sparse"),  # no gradient: K4's job
    ("cpu", torch.bfloat16, 1024, True, None, "sparse"),
    ("cpu", torch.bfloat16, 1024, True, "1", "k8"),
    ("cpu", torch.bfloat16, 1024, False, "1", "k8"),
    ("cpu", torch.float32, 1024, True, "1", "sparse"),
    ("cpu", torch.bfloat16, 512, True, "1", "chain"),
])
def test_the_trunk_grad_route_table(monkeypatch, device, dtype, n, grad, env, route):
    if env is None:
        monkeypatch.delenv("HPCD_TRUNK_FUSED_FWD", raising=False)
    else:
        monkeypatch.setenv("HPCD_TRUNK_FUSED_FWD", env)
    with torch.set_grad_enabled(grad):
        assert pencoder.trunk_grad_route(_cloud(device, dtype, n)) == route
        if device == "cpu":
            assert pencoder.trunk_grad_route(torch.empty((2, n, 3), dtype=dtype)) == route


def test_adam_lowp_keeps_torch_adams_state_names():
    params = [torch.nn.Parameter(torch.randn(5, 3)), torch.nn.Parameter(torch.randn(4))]
    lowp = optim.make_optimizer({"type": "Adam", "hyperparams": {
        "lr": 1e-3, "moment_dtype": "bfloat16"}}, params)
    plain = torch.optim.Adam(params, lr=1e-3)
    for opt in (lowp, plain):
        for p in params:
            p.grad = torch.ones_like(p)
        opt.step()
    for p in params:
        assert set(lowp.state[p]) == set(plain.state[p]) == {"step", "exp_avg", "exp_avg_sq"}
        assert lowp.state[p]["exp_avg"].dtype == lowp.state[p]["exp_avg_sq"].dtype == (
            torch.bfloat16)


def test_a_checkpoint_of_adam_lowp_keeps_the_mu_nu_layout_and_round_trips(tmp_path):
    """``_O.npz`` holds optax's leaves (counts, rate, every ``mu``, every
    ``nu``, in the JAX leaf order, bf16 as raw words), and a restore puts them
    back under ``exp_avg`` and ``exp_avg_sq``."""
    from tests.test_torch_models import tiny_config
    from hyperpocket_tpu_torch.models.full_model import FullModel

    cfg = {"type": "Adam", "hyperparams": {"lr": 1e-3, "moment_dtype": "bfloat16"}}
    model = FullModel.from_config(tiny_config(), torch.Generator().manual_seed(0))
    opt = optim.make_optimizer(cfg, model.parameters())
    for step in range(2):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=torch.Generator().manual_seed(step + p.numel()))
        opt.step()
    ckpt.save_checkpoint(str(tmp_path / "w"), str(tmp_path / "m"), 1, model, opt, 2, {},
                         [[0.0]], [[0.0]])
    with np.load(tmp_path / "w" / "00001_O.npz") as data:
        leaves = [data[f"arr_{i}"] for i in range(len(data.files))]
    ordered = ckpt._ordered_params(model, opt)
    n = len(ordered)
    assert len(leaves) == 3 + 2 * n and int(leaves[0]) == int(leaves[2]) == 2
    for k, key in enumerate(("exp_avg", "exp_avg_sq")):  # optax's mu, then nu
        for i, (name, p) in enumerate(ordered):
            saved = leaves[3 + k * n + i]
            assert saved.dtype == np.dtype("V2")
            want = ckpt._jax_layout(name, opt.state[p][key]).contiguous()
            assert saved.tobytes() == want.view(torch.int16).numpy().tobytes()

    again = FullModel.from_config(tiny_config(), torch.Generator().manual_seed(1))
    restored = optim.make_optimizer(cfg, again.parameters())
    _, count = ckpt.restore_model_state(str(tmp_path / "w"), str(tmp_path / "m"), 1, 1,
                                        again, restored)
    assert count == 2
    for p, q in zip(model.parameters(), again.parameters()):
        assert torch.equal(p, q)
        assert set(restored.state[q]) == {"step", "exp_avg", "exp_avg_sq"}
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(restored.state[q][key], opt.state[p][key])
        assert float(restored.state[q]["step"]) == 2
