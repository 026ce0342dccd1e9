"""The bf16 training decode's route and its backward, ``ops/decoder.py``.

``decode_grad_route`` sends the training forward's decode to K10 and
``decode_batch_grad`` only for bf16 under autograd on a card (asked here on
fake CUDA tensors); everything else keeps the ``bmm`` chain. On the CPU the
op ``hyperpocket::decode_batch_grad`` runs ``decode_batch_grad_reference``,
which is held here to autograd through the chain
(``models/target_network.py``): equal in fp64 within 1e-12, and in bf16
within one bf16 rounding of each value (both round each fp32 sum once). The
CUDA kernel is held to the plain version and to the chain on the card
(tests/test_torch_cuda.py). The model's training forward counts its route
under a profiler (``decoder.grad_route.<route>``) and, sent to "k10", trains
as the chain does.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.profiler import ProfilerActivity, profile

from hyperpocket_tpu_torch.models.full_model import FullModel
from hyperpocket_tpu_torch.models.hyper_network import target_weight_count
from hyperpocket_tpu_torch.models.target_network import batched_target_network_forward
from hyperpocket_tpu_torch.ops import decoder
from hyperpocket_tpu_torch.utils import profiling
from tests.test_torch_models import inputs, tiny_config

CHAIR = (32, 64, 128, 64)
CHANNELS = [CHAIR, (8, 16), (16,), ()]
BF16_STEP = 2.0 ** -8  # a bf16 value's rounding, relative


def _grad_inputs(channels, use_bias, batch=3, n=77, seed=0, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    w = target_weight_count(list(channels), use_bias)
    flat = torch.from_numpy(rng.standard_normal((batch, w)) * 0.3).to(dtype)
    pts = torch.from_numpy(rng.standard_normal((batch, n, 3)) * 0.5).to(dtype)
    g = torch.from_numpy(rng.standard_normal((batch, n, 3)) / n).to(dtype)
    return flat, pts, g


def _chain_grad(flat, pts, g, channels, use_bias):
    f = flat.clone().requires_grad_()
    batched_target_network_forward(f, pts, list(channels), use_bias).backward(g)
    return f.grad


def _cuda_like(dtype=torch.bfloat16, requires_grad=False, shape=(4, 19011)):
    with FakeTensorMode():
        return torch.empty(shape, device="cuda", dtype=dtype).requires_grad_(requires_grad)


@pytest.mark.parametrize("case", ["cpu", "fp32", "fp64", "no_grad", "points_need_grad",
                                  "wide_272", "too_many_layers", "card_bf16"])
def test_the_route_is_k10_only_for_bf16_under_autograd_on_a_card(case):
    channels = {"wide_272": (272,), "too_many_layers": (16,) * decoder.MAX_LAYERS}.get(
        case, CHAIR)
    dtype = {"fp32": torch.float32, "fp64": torch.float64}.get(case, torch.bfloat16)
    if case == "cpu":
        flat = torch.empty((4, 19011), dtype=dtype, requires_grad=True)
        pts = torch.empty((4, 2048, 3), dtype=dtype)
    else:
        flat = _cuda_like(dtype, requires_grad=True)
        pts = _cuda_like(dtype, requires_grad=case == "points_need_grad", shape=(4, 2048, 3))
    with torch.set_grad_enabled(case != "no_grad"):
        route = decoder.decode_grad_route(flat, pts, channels)
    assert route == ("k10" if case == "card_bf16" else "chain")


def test_the_route_reads_the_widths_both_kernels_take():
    """The backward's limits, inside the tensor-core K10's (hidden layers up
    to 256 channels): hidden layers up to 128 channels, at most 80 blocks
    of 16 x 16 in the weights' gradient, a block's shared memory; all
    decided from the widths."""
    flat, pts = _cuda_like(requires_grad=True), _cuda_like(shape=(4, 2048, 3))
    for channels, want in ((CHAIR, "k10"), ((128,), "k10"), ((40, 24, 72), "k10"),
                           ((8, 16), "k10"), ((), "k10"), ((129,), "chain"), ((256,), "chain"),
                           ((96, 96, 96, 96), "chain"), ((256, 256), "chain")):
        assert decoder.decode_grad_route(flat, pts, channels) == want, channels
        assert decoder.decode_grad_route(flat, pts, channels, use_bias=False) == want, channels


def test_the_layout_at_the_chair_widths():
    """The weights 44,864 bytes, a tile's 128 points of activations and
    gradients 176,128 and db 1,216: 222,208 of a block's 232,448; 78
    blocks of dW."""
    layout = decoder.grad_layout(CHAIR, True)
    assert (layout.smem_bytes, layout.flat) == (222_208, 19_011)
    assert len(layout.words) == 1 + 11 * decoder.MAX_LAYERS + 1 + 80 + 2  # the kernel's Layout
    assert sum(u >= 0 for u in layout.words[-82:-2]) == 78
    # the biases staged as zeros
    assert decoder.grad_layout(CHAIR, False).smem_bytes == 222_208
    assert decoder.grad_layout((512, 512), True) is None


@pytest.mark.parametrize("batch,n,sms,want", [(64, 2048, 132, (2, 1024)), (3, 77, 132, (1, 128)),
                                              (1, 2048, 132, (16, 128)),
                                              (256, 2048, 132, (1, 2048)),
                                              (64, 1000, 132, (2, 512))])
def test_each_sample_is_cut_into_chunks_of_whole_tiles(batch, n, sms, want):
    chunks, points = decoder.grad_chunks(batch, n, sms)
    assert (chunks, points) == want
    assert points % decoder.GRAD_TILE == 0 and (chunks - 1) * points < n <= chunks * points


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("channels", CHANNELS)
def test_the_plain_backward_is_the_chains_autograd_in_fp64(channels, use_bias):
    flat, pts, g = _grad_inputs(channels, use_bias)  # 77 points: a ragged count
    got = decoder.decode_batch_grad(flat, pts, g, channels, use_bias)
    want = _chain_grad(flat, pts, g, channels, use_bias)
    assert got.dtype == torch.float64 and got.shape == flat.shape
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("channels", CHANNELS)
def test_the_plain_backward_is_the_chains_autograd_in_bf16(channels, use_bias):
    flat, pts, g = _grad_inputs(channels, use_bias, seed=1, dtype=torch.bfloat16)
    got = decoder.decode_batch_grad(flat, pts, g, channels, use_bias).double()
    want = _chain_grad(flat, pts, g, channels, use_bias).double()
    assert (got - want).abs().max() <= BF16_STEP * want.abs().max() * 1e-3 + (
        BF16_STEP * want.abs()).max()


@pytest.mark.parametrize("use_bias", [True, False])
def test_the_grad_op_opcheck_and_its_fake_kernel(use_bias):
    flat, pts, g = _grad_inputs((8, 16), use_bias, dtype=torch.float32)
    torch.library.opcheck(torch.ops.hyperpocket.decode_batch_grad.default,
                          (flat, pts, g, [8, 16], use_bias))
    with FakeTensorMode():
        out = torch.ops.hyperpocket.decode_batch_grad(
            torch.empty((5, flat.shape[1]), dtype=torch.bfloat16),
            torch.empty((5, 7, 3), dtype=torch.bfloat16),
            torch.empty((5, 7, 3), dtype=torch.bfloat16), [8, 16], use_bias)
    assert tuple(out.shape) == (5, flat.shape[1]) and out.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="not shaped as the points"):
        decoder.decode_batch_grad(flat, pts, g[:, 1:], (8, 16), use_bias)
    before = decoder.decode_batch_grad.launches
    decoder.decode_batch_grad(flat, pts, g, (8, 16), use_bias)
    assert decoder.decode_batch_grad.launches == before  # the CPU launches nothing


def test_the_training_decode_gives_the_chains_value_and_gradient():
    """bf16, the one dtype the route sends there (K10's plain version
    computes in fp32)."""
    flat, pts, g = _grad_inputs(CHAIR, True, batch=2, n=50, seed=2, dtype=torch.bfloat16)
    f = flat.clone().requires_grad_()
    out = decoder.decode_batch_train(f, pts, CHAIR)
    out.backward(g)
    assert torch.equal(out, decoder.decode_batch(flat, pts, CHAIR, round_product=True))
    assert torch.equal(f.grad, decoder.decode_batch_grad_reference(flat, pts, g, CHAIR))
    chain = batched_target_network_forward(flat, pts, list(CHAIR))
    tol = 2 * BF16_STEP
    assert (out.double() - chain.double()).abs().max() <= tol * chain.double().abs().max()
    want = _chain_grad(flat, pts, g, CHAIR, True).double()
    assert (f.grad.double() - want).norm() <= tol * want.norm()


def _train_forward(model, seed=3):
    t = {k: torch.from_numpy(v) for k, v in inputs(model, seed=seed).items()}
    rec, mu, sigma = model.apply(t["existing"], t["missing"], None, 100.0,
                                 num_output_points=t["ball_points"].shape[1], training=True,
                                 vae_eps=t["vae_eps"], ball_points=t["ball_points"])
    return (rec.square().sum() + mu.square().sum() + sigma.sum()), rec


@pytest.fixture
def clean_totals():
    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("route", ["chain", "k10"])
def test_a_training_forward_counts_its_decode_route_under_a_profiler(monkeypatch, route,
                                                                     clean_totals):
    model = FullModel.from_config(tiny_config(compute_dtype="bfloat16"),
                                  torch.Generator().manual_seed(4))
    if route == "k10":  # the card's route, through the kernels' plain versions
        monkeypatch.setattr(decoder, "decode_grad_route", lambda *a: "k10")
    _train_forward(model)  # no profiler: nothing counted
    assert profiling.totals() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        _train_forward(model)
        with torch.no_grad():  # inference decodes through K10's op and counts no route
            zeros = torch.zeros((2, 64, 3))
            model.apply(zeros, zeros, None, 1.0, num_output_points=64, training=False,
                        noise=torch.zeros((2, model.get_noise_size())), ball_points=zeros)
    got = {k: n for k, (n, _) in profiling.totals().items() if k.startswith("decoder.")}
    assert got == {f"decoder.grad_route.{route}": 1}


def test_the_k10_route_trains_as_the_chain(monkeypatch):
    """The tiny bf16 HyperPocket model's loss and every parameter's gradient
    through ``decode_batch_train`` (the plain versions on the CPU) against
    the chain's: the same within bf16 rounding."""
    grads, recs = {}, {}
    for route in ("chain", "k10"):
        model = FullModel.from_config(tiny_config(compute_dtype="bfloat16"),
                                      torch.Generator().manual_seed(5))
        monkeypatch.setattr(decoder, "decode_grad_route", lambda *a, r=route: r)
        loss, recs[route] = _train_forward(model, seed=6)
        loss.backward()
        grads[route] = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    assert torch.equal(recs["k10"], recs["chain"])
    assert grads["k10"].keys() == grads["chain"].keys() and grads["k10"]
    for name, want in grads["chain"].items():
        got = grads["k10"][name]
        assert (got - want).norm() <= 4 * BF16_STEP * want.norm() + 1e-30, name
