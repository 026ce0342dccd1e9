"""Data-parallel eval and serving on two gloo ranks vs one process and the JAX package.

One spawn of two CPU processes (``tests/torch_parallel_workers.py``) runs
the parallel cases; the assertions compare with one-process runs here.

* ``pairwise_emd_cd_multi(mesh=)``: each rank's share of every dispatch,
  gathered, equals the unsharded call's matrices.
* ``evaluate_generativity(parallel_data=2)`` on the JAX package's draws
  (recorded here, replayed by the ranks) equals the one-process run and
  the JAX package's own run with its 2-device mesh; ``parallel_data`` above
  the world size raises, naming the key.
* DP ``make_serving_fn`` and a ``data_parallel=2`` artifact serve the
  one-process output for the same seed; ``infer --artifact`` refuses the
  artifact, as the JAX package's CLI does.
"""

from __future__ import annotations

import json
from os.path import join

import numpy as np
import pytest
import torch

from hyperpocket_tpu.eval import experiments as jexp
from hyperpocket_tpu_torch import serving
from hyperpocket_tpu_torch.data.plyio import save_ply
from hyperpocket_tpu_torch.eval import experiments as pexp
from hyperpocket_tpu_torch.eval import metrics as pmetrics
from hyperpocket_tpu_torch.models.full_model import FullModel
from tests.test_torch_eval import RTOL_METRIC, JaxDraws, _objects
from tests.test_torch_models import model_pair, tiny_config
from tests.torch_parallel_workers import spawn

WORLD = 2
GEN = dict(batch_size=3, dispatch_clouds=8, include_1nna=True)
SERVE_B, SERVE_N, SERVE_OUT = 4, 64, 128
SERVE_CFG = tiny_config(compute_dtype="float64")


class RecordingDraws:
    """Passes another draws object through and keeps every array by counter value."""

    def __init__(self, inner):
        self.inner, self.arrays = inner, {}

    def noise(self, seed, batch, mean, std, source):
        out = self.inner.noise(seed, batch, mean, std, source)
        self.arrays[f"noise_{int(seed)}"] = np.asarray(out)
        return out

    def balls(self, seed, batch, num_points, epoch):
        out = self.inner.balls(seed, batch, num_points, epoch)
        self.arrays[f"balls_{int(seed)}"] = np.asarray(out)
        return out


def _pair_sets(seed: int = 4):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((5, 64, 3)) * 0.3).astype(np.float32),
            (rng.standard_normal((2, 7, 64, 3)) * 0.3).astype(np.float32))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve")
    rows, cols = _pair_sets()
    np.savez(out / "pairs.npz", rows=rows, cols=cols)

    # generativity: the one-process port run on the JAX draws, recorded
    jmodel, params, port = model_pair(tiny_config(), seed=3)
    np.savez(out / "gen_state.npz", **{k: v.numpy() for k, v in port.state_dict().items()})
    objs = _objects(2, 1024, 13)
    np.savez(out / "objects.npz", **{k: np.stack([o[i] for o in objs])
                                     for i, k in enumerate(("existing", "missing", "gt"))})
    draws = RecordingDraws(JaxDraws(jmodel))
    ctx = pexp.ExperimentContext(port.eval(), epoch=5, seed=7, device="cpu", draws=draws)
    one = pexp.evaluate_generativity(ctx, {"chair": objs}, str(out / "one"), 5, **GEN)
    np.savez(out / "draws.npz", **draws.arrays)
    jctx = jexp.ExperimentContext(jmodel, params, epoch=5, seed=7)
    jax_res = jexp.evaluate_generativity(jctx, {"chair": objs}, str(out / "jax"), 5,
                                         parallel_data=WORLD, **GEN)

    # serving, in fp64 so that the one-process rows round as the ranks' do:
    # the one-process output and a data_parallel=2 artifact
    smodel = FullModel.from_config(SERVE_CFG, torch.Generator().manual_seed(5))
    np.savez(out / "serve_state.npz", **{k: v.numpy() for k, v in smodel.state_dict().items()})
    rng = np.random.default_rng(8)
    existing = (rng.standard_normal((SERVE_B, SERVE_N, 3)) * 0.3).astype(np.float32)
    noise = (rng.standard_normal((SERVE_B, smodel.get_noise_size())) * 0.13).astype(np.float32)
    np.savez(out / "serve_inputs.npz", existing=existing, noise=noise)
    kw = dict(num_output_points=SERVE_OUT, epoch=50.0, device="cpu")
    want = serving.make_serving_fn(smodel, **kw)(existing, noise, 5).numpy()
    with open(out / "dp2.pt2", "wb") as fh:
        fh.write(serving.export_completion(smodel, batch=SERVE_B, n_existing=SERVE_N,
                                           data_parallel=WORLD, **kw))

    spawn([("eval_pairs", dict(rows_path=str(out / "pairs.npz"), generativity=dict(
               cfg=tiny_config(), state_path=str(out / "gen_state.npz"),
               draws_path=str(out / "draws.npz"), objects_path=str(out / "objects.npz")))),
           ("serve", dict(cfg=SERVE_CFG, state_path=str(out / "serve_state.npz"),
                          inputs_path=str(out / "serve_inputs.npz"),
                          artifact_path=str(out / "dp2.pt2"), num_output_points=SERVE_OUT,
                          epoch=50.0))], WORLD, out)
    return {"out": out, "one": one, "jax": jax_res, "serve_want": want}


def test_pair_matrices_over_the_mesh_equal_the_unsharded_call(run):
    res = np.load(run["out"] / "eval_pairs.npz")
    rows, cols = _pair_sets()
    for block in (64, 37):  # 37 rounds up to 38 to split over two ranks
        cd, emd = pmetrics.pairwise_emd_cd_multi(rows, cols, pair_block=block, device="cpu")
        assert cd.shape == res[f"cd_{block}"].shape == (2, 5, 7)
        np.testing.assert_allclose(res[f"cd_{block}"], cd, rtol=1e-6)
        np.testing.assert_allclose(res[f"emd_{block}"], emd, rtol=1e-6)


def test_parallel_evaluate_generativity_matches_one_process_and_jax(run):
    out = run["out"]
    with open(out / "generativity_rank0.json") as fh:
        rank0 = json.load(fh)["chair"]
    with open(out / "generativity_rank1.json") as fh:
        assert json.load(fh)["chair"] == rank0  # every rank returns the results
    with open(join(out, "evaluate_generativity", "5eval_gen_by_cat.json")) as fh:
        assert json.load(fh)["chair"] == rank0  # rank 0 wrote them
    one, jax_res = run["one"]["chair"], run["jax"]["chair"]
    assert set(rank0) == set(one) == set(jax_res)
    assert any(k.startswith("1-NN-EMD") for k in rank0)
    for k in one:
        if k.startswith(("cov", "1-NN")):
            assert rank0[k] == one[k] == jax_res[k], k
        else:
            assert rank0[k] == pytest.approx(one[k], rel=1e-6), k
            assert rank0[k] == pytest.approx(jax_res[k], rel=RTOL_METRIC), k
    errors = np.load(out / "eval_pairs.npz")["errors"]
    assert "evaluate_generativity.parallel_data=3" in errors[0]


def test_data_parallel_serving_and_artifact_equal_one_process(run, tmp_path):
    res = np.load(run["out"] / "serve.npz")
    assert int(res["world"]) == WORLD
    assert res["fn"].dtype == np.float64
    np.testing.assert_allclose(res["fn"], run["serve_want"], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(res["artifact"], run["serve_want"], rtol=1e-12, atol=1e-12)
    meta = serving.artifact_meta((run["out"] / "dp2.pt2").read_bytes())
    assert meta["data_parallel"] == WORLD and meta["batch"] == SERVE_B
    # the CLI drives single-process artifacts only
    artifact = str(run["out"] / "dp2.pt2")
    with open(artifact + ".json", "w") as fh:
        json.dump(meta, fh)
    save_ply(tmp_path / "a.ply", np.zeros((SERVE_N, 3), np.float32) + 0.1)
    with pytest.raises(SystemExit, match="single-process artifacts"):
        serving.main(["infer", "--artifact", artifact, "--inputs", str(tmp_path / "a.ply"),
                      "--out-dir", str(tmp_path / "o")])
