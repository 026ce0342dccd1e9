"""The port's compiled serving call (``utils/cuda_graph.py``, ``serving.py``) on the CPU.

On a card each serving callable captures its forward once per input
signature and replays it (``tests/test_torch_cuda.py`` holds the graphs to
the eager forward bit for bit); here, with CPU tensors, the forward runs
eagerly. These tests hold the signature key, the CPU route (the eager
``FullModel.apply`` bit for bit, and the JAX package's ``make_serving_fn`` on
the same weights and ball points: fp32 within the parity budget 1e-5, bf16
within 5% of the output's largest magnitude, as ``tests/test_torch_models.py``),
the serving net's own copy of the weights, and the graph module's CPU
branch and launch accounting.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperpocket_tpu import serving as jax_serving
from hyperpocket_tpu.ops.sampling import (
    generate_target_network_input_batch as jax_ball_points,
)
from hyperpocket_tpu_torch import serving
from hyperpocket_tpu_torch.models.full_model import (
    MODE_HYPER_CLOUD,
    MODE_HYPER_POCKET,
    MODE_HYPER_REC,
    FullModel,
)
from hyperpocket_tpu_torch.ops import launch_counters
from hyperpocket_tpu_torch.ops.decoder import decode_batch
from hyperpocket_tpu_torch.ops.trunk_pool import trunk_pooled
from hyperpocket_tpu_torch.train.epoch_scan import GraphCaptureError as ScanCaptureError
from hyperpocket_tpu_torch.utils.cuda_graph import (
    Graph,
    GraphCache,
    GraphCaptureError,
    signature,
    where,
)
from tests.test_torch_models import model_pair, tiny_config

torch.set_float32_matmul_precision("highest")

B, N_EXIST, N_OUT, EPOCH = 2, 64, 128, 50.0
FP32_TOL = 1e-5
BF16_SHARE = 0.05
MODES = [MODE_HYPER_POCKET, MODE_HYPER_REC, MODE_HYPER_CLOUD]


def _key(batch=4, n_existing=1024, points=2048, dtype="bfloat16", device="cpu"):
    """make_serving_fn's key: its inputs (existing, noise), then what the
    function fixes (compute dtype, output points)."""
    d = torch.device(device)
    return signature(torch.empty((batch, n_existing, 3), device=d),
                     torch.empty((batch, 128), device=d), static=(dtype, points))


@pytest.mark.parametrize("change", [{"batch": 8}, {"n_existing": 512}, {"points": 1024},
                                    {"dtype": "float32"}, {"device": "meta"}])
def test_a_new_batch_point_count_dtype_or_device_gives_a_new_key(change):
    assert _key(**change) != _key()
    assert _key(**change) == _key(**change)


def test_the_same_inputs_give_the_same_key():
    """Values do not enter the key: another request of the same shapes replays."""
    a = torch.zeros((4, 1024, 3))
    b = torch.randn((4, 1024, 3), generator=torch.Generator().manual_seed(0))
    assert signature(a, static=("float32",)) == signature(b, static=("float32",))
    assert hash(_key()) == hash(_key())


def _inputs(model, seed=0):
    rng = np.random.default_rng(seed)
    existing = rng.standard_normal((B, N_EXIST, 3)).astype(np.float32) * 0.3
    noise = rng.standard_normal((B, model.get_noise_size())).astype(np.float32) * 0.13
    return existing, noise


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_cpu_route_is_the_eager_apply(mode, dtype):
    """With CPU tensors a request is ``FullModel.apply`` with a generator
    seeded from the request's seed, bit for bit (the serving callable's own
    generator, seeded anew at each call), and no graph is made."""
    model = FullModel.from_config(tiny_config(mode, compute_dtype=dtype),
                                  torch.Generator().manual_seed(3))
    existing, noise = _inputs(model, seed=4)
    f = serving.make_serving_fn(model, num_output_points=N_OUT, epoch=EPOCH, device="cpu")
    served = model.serving_params()
    for seed in (5, 6):
        want = served.apply(torch.from_numpy(existing), None, torch.Generator().manual_seed(seed),
                            EPOCH, num_output_points=N_OUT, training=False,
                            noise=torch.from_numpy(noise))
        assert torch.equal(f(existing, noise, seed), want)
    assert f.graphs.graphs == {} and f.graphs.replays == 0
    assert f.graphs.static == (dtype, N_OUT)


def _jax_balls(jmodel, seed: int) -> np.ndarray:
    """The ball points JAX's ``make_serving_fn`` draws for ``seed``
    (``FullModel.apply`` splits the key and draws from the second half)."""
    _, k_pts = jax.random.split(jax.random.key(seed))
    return np.asarray(jax_ball_points(jmodel.target_network_input, k_pts,
                                      jnp.asarray(EPOCH, jnp.float32), B, N_OUT,
                                      method=jmodel.ball_method))


def _inject(monkeypatch, balls: np.ndarray) -> list:
    """The port's serving draw replaced by ``balls``; returns its calls."""
    calls = []

    def draw(net_input, generator, epoch, batch, num_points, *, method):
        calls.append((float(epoch), batch, num_points, method))
        return torch.tensor(balls)

    monkeypatch.setattr(serving, "generate_target_network_input_batch", draw)
    return calls


@pytest.mark.parametrize("dtype, mode", [("float32", m) for m in MODES]
                         + [("bfloat16", MODE_HYPER_POCKET)])
def test_cpu_route_matches_jax_make_serving_fn(monkeypatch, mode, dtype):
    """The same weights and ball points through both packages' ``make_serving_fn``."""
    jmodel, params, port = model_pair(tiny_config(mode, compute_dtype=dtype), seed=7)
    existing, noise = _inputs(port, seed=8)
    want = np.asarray(jax_serving.make_serving_fn(jmodel, params, num_output_points=N_OUT,
                                                  epoch=EPOCH)(existing, noise, 9))
    calls = _inject(monkeypatch, _jax_balls(jmodel, 9))
    got = serving.make_serving_fn(port, num_output_points=N_OUT, epoch=EPOCH,
                                  device="cpu")(existing, noise, 9).numpy()
    assert calls == [(EPOCH, B, N_OUT, port.ball_method)]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=FP32_TOL)
    else:
        assert np.abs(got - want).max() <= BF16_SHARE * np.abs(want).max()


@pytest.mark.parametrize("mode", [MODE_HYPER_POCKET, MODE_HYPER_REC])
def test_cpu_artifact_matches_jax_make_serving_fn(monkeypatch, mode):
    """``load_completion`` of a CPU artifact: eager, and JAX's completion on
    the same weights and ball points within the parity budget."""
    jmodel, params, port = model_pair(tiny_config(mode), seed=10)
    existing, noise = _inputs(port, seed=11)
    want = np.asarray(jax_serving.make_serving_fn(jmodel, params, num_output_points=N_OUT,
                                                  epoch=EPOCH)(existing, noise, 12))
    f = serving.load_completion(serving.export_completion(
        port, batch=B, n_existing=N_EXIST, num_output_points=N_OUT, epoch=EPOCH, device="cpu"))
    calls = _inject(monkeypatch, _jax_balls(jmodel, 12))
    got = f(existing, noise, 12).numpy()
    assert calls == [(EPOCH, B, N_OUT, port.ball_method)]
    np.testing.assert_allclose(got, want, atol=FP32_TOL)
    assert f.graphs.graphs == {} and f.graphs.static == ("float32",)


@pytest.mark.parametrize("source", ["model", "module", "state_dict"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_serving_net_owns_its_weights(source, dtype):
    """Updating the caller's weights after ``make_serving_fn`` leaves the
    completion as it was: the serving net holds a snapshot, in fp32 too."""
    model = FullModel.from_config(tiny_config(compute_dtype=dtype),
                                  torch.Generator().manual_seed(13))
    other = FullModel.from_config(tiny_config(compute_dtype=dtype),
                                  torch.Generator().manual_seed(14))
    given = {"model": None, "module": other, "state_dict": other.state_dict()}[source]
    f = serving.make_serving_fn(model, given, num_output_points=N_OUT, device="cpu")
    existing, noise = _inputs(model, seed=15)
    before = f(existing, noise, 16)
    with torch.no_grad():
        for m in (model, other):
            for p in m.parameters():
                p.mul_(1.5).add_(0.25)
    assert torch.equal(f(existing, noise, 16), before)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_graph_cache_runs_eagerly_on_the_cpu():
    """Off the card the function runs at every call, and nothing is captured."""
    calls = []

    def fn(a, b):
        calls.append(a.shape)
        return a * 2 + b

    cache = GraphCache(fn, "cpu", name="f", static=("float32",))
    x, y = torch.ones(3), torch.arange(3.0)
    for n in (1, 2):
        assert torch.equal(cache(x, y), x * 2 + y) and len(calls) == n
    assert torch.equal(cache(torch.ones(5), torch.zeros(5)), torch.full((5,), 2.0))
    assert (cache.graphs, cache.first_call_ms, cache.replays) == ({}, {}, 0)


def test_a_replay_adds_the_launches_its_capture_recorded(monkeypatch):
    """``Graph.replay`` replays and adds each counter's recorded launches."""
    monkeypatch.setattr(trunk_pooled, "launches", 7)
    monkeypatch.setattr(decode_batch, "launches", 3)

    class Recorded:
        replays = 0

        def replay(self):
            self.replays += 1

    per_replay = [{trunk_pooled: 1, decode_batch: 2}.get(owner, 0) if attr == "launches" else 0
                  for owner, attr in launch_counters()]
    graph = Graph(Recorded(), None, per_replay, capture_ms=1.0, pool_bytes=0)
    for _ in range(3):
        graph.replay()
    assert graph.graph.replays == 3
    assert (trunk_pooled.launches, decode_batch.launches) == (10, 9)


def test_where_names_the_line_that_failed():
    """The innermost frame outside torch: the caller's line, not torch's."""
    def body():
        return torch.ones(2).view(3)  # the failing line

    with pytest.raises(RuntimeError) as info:
        body()
    got = where(info.value)
    assert "torch.ones(2).view(3)" in got and got.startswith(__file__)
    assert ScanCaptureError is GraphCaptureError and issubclass(GraphCaptureError, RuntimeError)
