"""Port's fused head-Adam update (K11, ``ops/head_adam.py``) vs the JAX package.

The plain version ``head_adam_update_reference`` works in the port's
``nn.Linear`` layout, p, m, v of shape (N, K); the JAX kernel's are (K, N),
so the port's results are compared transposed. Held to
``head_adam_update(interpret=True)`` at odd widths with fp32 and bf16
moments: p within 1e-6 absolute (the update is ~lr = 1e-3; dw's sums run
in other orders), m and v within 1e-6 relative (fp32) or one bf16 step
(bf16), plus 1e-6 of the tensor's largest entry for values that cancel to
near zero; the Adam
scalars to fp32 rounding. Five steps are held to optax's Adam (1e-6), and
the port's ``make_fused_train_step`` to the JAX one on the tiny config of
tests/test_pallas_head_adam.py (fp32 moments, the same weights and draws):
step-0 loss within 1e-6 relative, three steps within 1e-3 of the JAX fused
step and 1e-4 of the port's plain step, head weights within 5e-3 and 99% of
them within 1e-5. Later steps carry Adam's sign flips of near-zero gradients
(the first update is lr * sign(g)), as the JAX test notes; on this config the
two packages' plain steps part by 1.3e-4 at step 3 for that reason. The CUDA kernel is held to
the plain version on the card in tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hyperpocket_tpu.models import FullModel as JaxModel
from hyperpocket_tpu.ops.pallas_head_adam import adam_scalars as jax_adam_scalars
from hyperpocket_tpu.ops.pallas_head_adam import head_adam_update as jax_head_adam_update
from hyperpocket_tpu.train import optim as joptim
from hyperpocket_tpu.train import trainer as jtrainer
from hyperpocket_tpu_torch.convert import params_from_jax
from hyperpocket_tpu_torch.models.full_model import FullModel
from hyperpocket_tpu_torch.ops.head_adam import (
    adam_scalars,
    head_adam_update,
    head_adam_update_reference,
)
from hyperpocket_tpu_torch.train import optim, trainer

torch.set_float32_matmul_precision("highest")

B1, B2, EPS, LR = 0.9, 0.999, 1e-8, 1e-3


def _bf16_step(x: np.ndarray) -> np.ndarray:
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("count", [1, 3, 1000])
def test_adam_scalars_match_jax(count):
    got = adam_scalars(LR, B1, B2, EPS, count)
    want = np.asarray(jax_adam_scalars(LR, B1, B2, EPS, count))
    assert got.dtype == torch.float32 and got.shape == (6,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-7, atol=0)


@pytest.mark.parametrize("n", [512, 640, 339])
@pytest.mark.parametrize("mdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_reference_matches_jax_kernel_interpret(n, mdtype, in_dtype):
    k, b = 256, 8
    rng = np.random.default_rng(0)
    h = rng.standard_normal((b, k)).astype(np.float32)
    dout = (rng.standard_normal((b, n)) * 0.1).astype(np.float32)
    p = rng.standard_normal((k, n)).astype(np.float32)
    m = (rng.standard_normal((k, n)) * 0.01).astype(np.float32)
    v = rng.uniform(0, 0.01, (k, n)).astype(np.float32)
    jdt, tdt = jnp.dtype(mdtype), getattr(torch, mdtype)
    jin, tin = jnp.dtype(in_dtype), getattr(torch, in_dtype)
    jp, jm, jv = jax_head_adam_update(
        jnp.asarray(h, jin), jnp.asarray(dout, jin), jnp.asarray(p), jnp.asarray(m, jdt),
        jnp.asarray(v, jdt), jax_adam_scalars(LR, B1, B2, EPS, 3), tile_n=256, interpret=True)

    tp = torch.from_numpy(p.T.copy())
    tm = torch.from_numpy(m.T.copy()).to(tdt)
    tv = torch.from_numpy(v.T.copy()).to(tdt)
    out = head_adam_update(torch.from_numpy(h).to(tin), torch.from_numpy(dout).to(tin), tp, tm,
                           tv, adam_scalars(LR, B1, B2, EPS, 3))
    assert out[0] is tp and out[1] is tm and out[2] is tv  # in place
    assert tm.dtype == tdt and tv.dtype == tdt
    np.testing.assert_allclose(tp.numpy().T, np.asarray(jp), atol=1e-6, rtol=0)
    for got, want in ((tm, jm), (tv, jv)):
        got = got.float().numpy().T
        want = np.asarray(want, np.float32)
        floor = 1e-6 * np.abs(want).max()
        bound = (1e-6 * np.abs(want) if mdtype == "float32" else _bf16_step(want)) + floor
        assert (np.abs(got - want) <= bound).all()


def test_reference_multi_step_matches_optax():
    """Five steps on the same gradient stream as optax's Adam (fp32 moments)."""
    k, n, b = 128, 384, 4
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((k, n)).astype(np.float32)
    tx = optax.chain(optax.scale_by_adam(b1=B1, b2=B2, eps=EPS), optax.scale(-LR))
    p_ref = jnp.asarray(p0)
    state = tx.init(p_ref)
    tp = torch.from_numpy(p0.T.copy())
    tm, tv = torch.zeros((n, k)), torch.zeros((n, k))
    for t in range(1, 6):
        h = rng.standard_normal((b, k)).astype(np.float32)
        dout = (rng.standard_normal((b, n)) * 0.1).astype(np.float32)
        upd, state = tx.update(jnp.asarray(h).T @ jnp.asarray(dout), state, p_ref)
        p_ref = optax.apply_updates(p_ref, upd)
        head_adam_update_reference(torch.from_numpy(h), torch.from_numpy(dout), tp, tm, tv,
                                   adam_scalars(LR, B1, B2, EPS, t))
    np.testing.assert_allclose(tp.numpy().T, np.asarray(p_ref), atol=1e-6)


def test_wrapper_checks_shapes_and_takes_plain_path_on_cpu():
    h, dout = torch.randn(2, 8), torch.randn(2, 6)
    p, m, v = torch.randn(6, 8), torch.zeros(6, 8), torch.zeros(6, 8)
    sc = adam_scalars(LR, B1, B2, EPS, 1)
    before = head_adam_update.launches
    head_adam_update(h, dout, p, m, v, sc)
    assert head_adam_update.launches == before
    with pytest.raises(ValueError, match=r"\(N, K\)"):
        head_adam_update(h, dout, p.T, m, v, sc)
    with pytest.raises(ValueError, match="fp32"):
        head_adam_update(h, dout, p.double(), m, v, sc)
    with pytest.raises(ValueError, match="share"):
        head_adam_update(h, dout, p, m, v.to(torch.bfloat16), sc)
    with pytest.raises(ValueError, match="6 Adam scalars"):
        head_adam_update(h, dout, p, m, v, sc[:5])


# ---------------------------------------------------------------------------
# The fused train step, tests/test_pallas_head_adam.py's tiny config

_CFG = {
    "random_encoder": {"output_size": 16, "use_bias": True, "relu_slope": 0.2},
    "real_encoder": {"output_size": 16, "use_bias": True, "relu_slope": 0.2},
    "hyper_network": {"use_bias": True, "relu_slope": 0.2},
    "target_network": {"use_bias": True, "relu_slope": 0.2, "freeze_layers_learning": False,
                       "layer_out_channels": [8, 16, 8]},
    "target_network_input": {"constant": False,
                             "normalization": {"enable": False, "type": "progressive",
                                               "epoch": 100}},
}
_OPT = {"type": "Adam", "hyperparams": {"lr": LR}}


def _data():
    rng = np.random.default_rng(2)
    return {
        "ex": rng.standard_normal((4, 64, 3)).astype(np.float32),
        "mi": rng.standard_normal((4, 64, 3)).astype(np.float32),
        "gt": rng.standard_normal((4, 128, 3)).astype(np.float32),
        "eps": [rng.standard_normal((4, 16)).astype(np.float32) for _ in range(3)],
        "balls": [rng.uniform(-0.5, 0.5, (4, 128, 3)).astype(np.float32) for _ in range(3)],
    }


def _jax_fused(params, d):
    mask = jax.tree_util.tree_map_with_path(
        lambda path, _: [getattr(q, "key", None) for q in path][-3:] != ["hyper_network",
                                                                       "heads", "w"], params)
    tx = joptim.make_optimizer(_OPT, mask)
    model = JaxModel.from_config(_CFG)
    step = jtrainer.make_fused_train_step(model, tx, 0.05)
    p = jax.tree_util.tree_map(jnp.copy, params)
    s = tx.init(p)
    hs = jtrainer.init_head_adam_state(p, "float32")
    losses = []
    for i in range(3):
        p, s, hs, loss, *_ = step(p, s, hs, jnp.asarray(d["ex"]), jnp.asarray(d["mi"]),
                                  jnp.asarray(d["gt"]), np.uint32(i), jnp.asarray(1.0),
                                  num_points=128, vae_eps=jnp.asarray(d["eps"][i]),
                                  ball_points=jnp.asarray(d["balls"][i]))
        losses.append(float(loss))
    return losses, np.asarray(p["hyper_network"]["heads"]["w"]).T


def _port_steps(params, d, fused: bool):
    port = FullModel.from_config(_CFG)
    port.load_state_dict(params_from_jax(jax.device_get(params)))
    w = port.hyper_network.heads.weight
    if fused:
        opt = optim.make_optimizer(_OPT, [p for p in port.parameters() if p is not w])
        step = trainer.make_fused_train_step(port, opt, 0.05)
        hs = trainer.init_head_adam_state(port, "float32")
        run = lambda *a, **k: step(hs, *a, **k)  # noqa: E731
    else:
        run = trainer.make_train_step(port, optim.make_optimizer(_OPT, port.parameters()), 0.05)
    t = {k: torch.from_numpy(d[k]) for k in ("ex", "mi", "gt")}
    losses = []
    for i in range(3):
        loss, *_ = run(t["ex"], t["mi"], t["gt"], None, 1.0, 128,
                       vae_eps=torch.from_numpy(d["eps"][i]),
                       ball_points=torch.from_numpy(d["balls"][i]))
        losses.append(loss.item())
    if fused:
        assert hs["count"] == 3 and w.grad is None
    return losses, w.detach().numpy()


def test_fused_train_step_matches_jax_fused_step():
    params = JaxModel.from_config(_CFG).init(jax.random.key(0))
    d = _data()
    want, want_w = _jax_fused(params, d)
    got, got_w = _port_steps(params, d, fused=True)
    plain, plain_w = _port_steps(params, d, fused=False)
    for other, other_w, rtol in ((want, want_w, 1e-3), (plain, plain_w, 1e-4)):
        assert got[0] == pytest.approx(other[0], rel=1e-6)
        np.testing.assert_allclose(got, other, rtol=rtol)
        np.testing.assert_allclose(got_w, other_w, atol=5e-3)
        assert np.mean(np.abs(got_w - other_w) < 1e-5) > 0.99


def test_fused_step_refuses_an_optimizer_holding_the_head_weight():
    port = FullModel.from_config(_CFG)
    with pytest.raises(ValueError, match="leave it out"):
        trainer.make_fused_train_step(port, optim.make_optimizer(_OPT, port.parameters()), 0.05)


def test_head_taps_return_the_trunk_and_the_cotangent():
    """``head_delta``'s gradient is the head output's cotangent; the head weight
    gets none; ``h`` is the hypernetwork trunk's output."""
    params = JaxModel.from_config(_CFG).init(jax.random.key(1))
    port = FullModel.from_config(_CFG)
    port.load_state_dict(params_from_jax(jax.device_get(params)))
    d = _data()
    t = {k: torch.from_numpy(d[k]) for k in ("ex", "mi", "gt")}
    delta = torch.zeros((4, port.hyper_network.heads.out_features), requires_grad=True)
    rec, mu, sigma, h = port.apply(t["ex"], t["mi"], None, 1.0, num_output_points=128,
                                   vae_eps=torch.from_numpy(d["eps"][0]),
                                   ball_points=torch.from_numpy(d["balls"][0]),
                                   head_delta=delta, return_trunk=True)
    (rec ** 2).sum().backward()
    assert port.hyper_network.heads.weight.grad is None
    assert port.hyper_network.heads.bias.grad is not None
    assert h.shape == (4, 2048)
    # dW from the taps equals autograd's head-weight gradient without them
    port.zero_grad(set_to_none=True)
    rec2 = port.apply(t["ex"], t["mi"], None, 1.0, num_output_points=128,
                      vae_eps=torch.from_numpy(d["eps"][0]),
                      ball_points=torch.from_numpy(d["balls"][0]))[0]
    (rec2 ** 2).sum().backward()
    torch.testing.assert_close(delta.grad.T @ h.detach(), port.hyper_network.heads.weight.grad,
                               rtol=1e-5, atol=1e-6)
    out = port.apply(t["ex"], t["mi"], torch.Generator().manual_seed(0), 1.0,
                     num_output_points=128, training=False, return_trunk=True)
    assert isinstance(out, tuple) and out[1].shape == (4, 2048)
