"""The program's spans and counters (``utils/profiling.py``) on the CPU.

With no profiler a span is one shared no-op object: it allocates nothing,
enters no ``record_function``, and a serving call and a scanned Trainer
epoch leave the totals empty. Under ``torch.profiler.profile`` the spans
sit in the exported Chrome trace on the calling thread, nested as the
layers call each other, and the totals count the calls, epochs, batches
and items run. The loader's producer thread, which the profiler does not
record, counts its items and collates only when the consumer records, and
a loader error still reaches the consumer. On a cached 3D-EPN tree the
loaders take the resident route (``data/loader.py``) and count
``loader.resident`` once a loader an epoch, beside the items, batches and
receipts that the benchmark's loader readers find. The encoder's trunk
counts the route it takes (``encoder.trunk_route.<route>``) and
``AdamLowp`` the values it updates (``adam_lowp.values``) under a profiler
only: without one neither calls ``count``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import tracemalloc
from os.path import join

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hyperpocket_tpu_torch.data.loader import BatchLoader
from hyperpocket_tpu_torch.models.full_model import FullModel
from hyperpocket_tpu_torch.serving import make_serving_fn
from hyperpocket_tpu_torch.train.trainer import Trainer
from hyperpocket_tpu_torch.utils import profiling
from tests.test_data import make_synthetic_shapenet
from tests.test_torch_loader_resident import make_3depn_slices, tree_3depn_config
from tests.test_train_integration import make_config

B, N_EXIST, N_OUT, ZDIM = 2, 32, 64, 16
TRAIN_BATCHES = 3  # 7 train objects in batches of 2, the last dropped
VAL_BATCHES = 3  # 5 val objects: two scanned, a ragged tail step
SERVING = ("serving.completion", "serving.upload", "serving.replay")
EPOCH = ("trainer.train_epoch", "trainer.val_epoch", "trainer.collect", "loader.wait",
         "loader.upload", "scan.fill", "scan.replay", "trainer.tail_step", "trainer.fetch")


@pytest.fixture(autouse=True)
def clean_totals():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    names = make_synthetic_shapenet(root, n_models=12, n_gt=64, n_part=32)
    for split, sel in (("train", names[:7]), ("val", names[7:]), ("test", names[:1])):
        with open(join(root, split + ".list"), "w") as fh:
            fh.write("\n".join(sel) + "\n")
    cfg = make_config(root, tmp_path_factory.mktemp("results"), max_epoch=1, batch=2)
    cfg["training"].update(epoch_mode="scan", min_save_epoch=1)
    return cfg


@pytest.fixture(scope="module")
def serve(config):
    model = FullModel.from_config(config["full_model"], torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    existing = rng.standard_normal((B, N_EXIST, 3)).astype(np.float32) * 0.3
    noise = rng.standard_normal((B, ZDIM)).astype(np.float32) * 0.1
    fn = make_serving_fn(model, num_output_points=N_OUT, device="cpu")
    return lambda seed: fn(existing, noise, seed)


def _epochs(config, n: int = 1) -> Trainer:
    t = Trainer(config, device="cpu")
    for epoch in range(1, n + 1):
        t.train_epoch(epoch)
        t.val_epoch(epoch)
    return t


def _traced(tmp_path, work) -> list[dict]:
    """``work()`` under a CPU profiler; the exported trace's complete events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        return [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]


def _inside(inner: dict, outer: dict) -> bool:
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_a_span_without_a_profiler_is_one_shared_object(monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("a span entered a profiler range with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refused)
    assert not profiling.recording()
    assert profiling.span("a") is profiling.span("b", 3) is profiling._OFF
    tracemalloc.start()
    try:
        for _ in range(1000):
            with profiling.span("serving.completion"):
                pass
        snapshot = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = snapshot.filter_traces([tracemalloc.Filter(True, profiling.__file__)])
    assert sum(stat.size for stat in mine.statistics("filename")) == 0
    assert profiling.totals() == {}


def test_a_span_holds_its_args_where_the_profiler_records_shapes(tmp_path):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with profiling.span("epoch", 7):
            pass
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as fh:
        (event,) = [e for e in json.load(fh)["traceEvents"] if e.get("name") == "epoch"]
    assert event["args"]["Concrete Inputs"] == ["7"]
    assert profiling.totals()["epoch"][0] == 1


def test_serving_and_an_epoch_leave_no_totals_without_a_profiler(config, serve):
    serve(3)
    t = _epochs(config)
    assert t.scan_invocations == 1 and t.val_scan_invocations == 1
    assert profiling.totals() == {}


def test_the_trace_holds_the_spans_nested_as_the_layers_call(tmp_path, config, serve):
    events = _traced(tmp_path, lambda: (serve(4), _epochs(config)))
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    for name in SERVING + EPOCH:
        assert name in by_name, name
    completion = by_name["serving.completion"][0]
    assert all(_inside(e, completion) for name in ("serving.upload", "serving.replay")
               for e in by_name[name])
    train = by_name["trainer.train_epoch"][0]
    collects = [c for c in by_name["trainer.collect"] if _inside(c, train)]
    assert len(collects) == 1
    waits = [w for w in by_name["loader.wait"] if _inside(w, collects[0])]
    assert len(waits) == TRAIN_BATCHES + 1  # the batches and the end of the epoch
    # the host route's prefix goes up in the loader, inside the collection
    assert all(any(_inside(u, c) for c in by_name["trainer.collect"])
               for u in by_name["loader.upload"])
    val = by_name["trainer.val_epoch"][0]
    assert any(_inside(s, val) for s in by_name["trainer.tail_step"])
    # the harness's names are its own
    assert not {"serve.call", "serve.to_host", "bench.window"} & set(by_name)


def test_the_totals_count_the_calls_epochs_batches_and_items(config, serve):
    calls, epochs = 3, 2
    with profile(activities=[ProfilerActivity.CPU]):
        for seed in range(calls):
            serve(seed)
        _epochs(config, epochs)
    got = {k: n for k, (n, _) in profiling.totals().items()}
    # the trunk's and the decode's routes and the epochs' dtype are counts with no seconds
    seconds = {k: s for k, (_, s) in profiling.totals().items()
               if not k.startswith(("encoder.trunk_route.", "decoder.grad_route.",
                                    "trainer.compute_dtype."))}
    assert all(s > 0 for s in seconds.values()), seconds
    steps = TRAIN_BATCHES + VAL_BATCHES
    assert got == {
        # a served call's real encoder; both encoders of every train and val step
        "encoder.trunk_route.chain": calls + 2 * steps * epochs,
        # every train step's decode (the CPU keeps the chain)
        "decoder.grad_route.chain": TRAIN_BATCHES * epochs,
        "serving.completion": calls, "serving.upload": calls, "serving.replay": calls,
        "trainer.train_epoch": epochs, "trainer.val_epoch": epochs,
        "trainer.compute_dtype.float32": epochs,
        "trainer.collect": 2 * epochs, "loader.upload": 2 * epochs,
        "loader.wait": (steps + 2) * epochs, "loader.items": (7 - 1 + 5) * epochs,
        "loader.collate": steps * epochs,
        "scan.fill": (steps - 1) * epochs, "scan.replay": (steps - 1) * epochs,
        "trainer.tail_step": epochs, "trainer.fetch": 2 * epochs}
    assert seconds["serving.upload"] <= seconds["serving.completion"]
    assert seconds["loader.wait"] <= seconds["trainer.collect"]


def test_the_training_profile_trace_holds_the_spans_and_the_log_their_totals(
        tmp_path, config, monkeypatch):
    cfg = dict(config, training={**config["training"],
                                 "profile": {"enable": True, "epochs": 1,
                                             "dir": str(tmp_path / "trace")}})
    t = Trainer(cfg, device="cpu")
    logged = []
    monkeypatch.setattr(t.log, "info", lambda msg, *args: logged.append(msg % args))
    t.run(plot_samples=False)
    with open(tmp_path / "trace" / "trace.json") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"trainer.train_epoch", "trainer.collect", "loader.wait", "scan.replay"} <= names
    # the profiler stops after the first train epoch: its val epoch is not traced
    assert "trainer.val_epoch" not in names
    spans = [line for line in logged if line.startswith("span ")]
    assert "span trainer.train_epoch: 1" in " ".join(spans)
    assert len(spans) == len(profiling.totals())


@pytest.fixture(scope="module")
def cached_config(tmp_path_factory):
    """A cached 3D-EPN tree of 10 items: 2 train batches of 4 (drop_last),
    val batches of 4, 4 and 2; its loaders take the resident route."""
    root = tmp_path_factory.mktemp("epn")
    make_3depn_slices(root)
    return tree_3depn_config(root, tmp_path_factory.mktemp("results_epn"), True, "scan")


def test_a_cached_corpus_counts_the_resident_loader_for_the_benchmark_readers(cached_config):
    from benchmark import harness

    epochs = 2
    with profile(activities=[ProfilerActivity.CPU]):
        t = _epochs(cached_config, epochs)
    assert t.train_loader.resident and all(v.resident for v in t.val_loaders.values())
    got = {k: n for k, (n, _) in profiling.totals().items()}
    seconds = {k: s for k, (_, s) in profiling.totals().items()}
    batches = 2 + 3
    receipts = 1 + 2  # each scanned prefix whole, and the val category's ragged batch
    assert {k: got[k] for k in ("loader.resident", "loader.items", "loader.collate",
                                "loader.wait", "trainer.collect", "trainer.train_epoch")} == {
        "loader.resident": 2 * epochs, "loader.items": (8 + 10) * epochs,
        "loader.collate": batches * epochs, "loader.wait": receipts * epochs,
        "trainer.collect": 2 * epochs, "trainer.train_epoch": epochs}
    assert seconds["loader.resident"] > 0  # the builds, on the first epoch
    assert seconds["loader.wait"] <= seconds["trainer.collect"]
    for name in ("train.collect_ms_per_epoch", "train.loader_wait_ms_per_epoch",
                 "train.loader_busy_ms_per_epoch"):
        value = harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(
            None, {"kind": "train"})
        assert value is not None and value > 0, name


class _Items:
    """A dataset of ``n`` items whose item ``bad`` raises."""

    def __init__(self, n: int, bad: int | None = None):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            raise ValueError(f"item {i} is unreadable")
        return np.full((4, 3), i, np.float32), 0, np.zeros((4, 3), np.float32), "cat"


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("recorded", [False, True])
def test_the_producer_counts_only_when_the_consumer_records(workers, recorded):
    loader = BatchLoader(_Items(10), 3, num_workers=workers)
    if recorded:
        with profile(activities=[ProfilerActivity.CPU]):
            batches = list(loader.epoch(0))
    else:
        batches = list(loader.epoch(0))
    assert [len(b[0]) for b in batches] == [3, 3, 3, 1]
    got = {k: n for k, (n, _) in profiling.totals().items()}
    want = {"loader.items": 10, "loader.collate": 4}
    if workers:
        want["loader.wait"] = 5
    assert got == (want if recorded else {})


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("recorded", [False, True])
def test_a_loader_error_reaches_the_consumer(workers, recorded):
    loader = BatchLoader(_Items(10, bad=7), 3, num_workers=workers)
    with pytest.raises(ValueError, match="item 7"):
        if recorded:
            with profile(activities=[ProfilerActivity.CPU]):
                list(loader.epoch(0))
        else:
            list(loader.epoch(0))
    got = {k: n for k, (n, _) in profiling.totals().items()}
    assert got.get("loader.items", 0) == (6 if recorded else 0)  # the two whole batches


def test_counts_from_many_threads_lose_no_update():
    """More threads than cores adding to one total, switching often."""
    threads, adds = 4 * (os.cpu_count() or 1), 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [profiling.count("n", 1, 0.5)
                                                    for _ in range(adds)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert profiling.totals() == {"n": (threads * adds, 0.5 * threads * adds)}


@pytest.mark.parametrize("env, dtype, n, route", [
    ("1", torch.bfloat16, 1024, "k8"), (None, torch.bfloat16, 1024, "sparse"),
    ("1", torch.float32, 1024, "sparse"), (None, torch.float32, 64, "chain")])
def test_the_trunk_route_is_counted_under_a_profiler_and_nowhere_else(monkeypatch, env, dtype,
                                                                        n, route):
    from hyperpocket_tpu_torch.models.encoder import Encoder

    if env is None:
        monkeypatch.delenv("HPCD_TRUNK_FUSED_FWD", raising=False)
    else:
        monkeypatch.setenv("HPCD_TRUNK_FUSED_FWD", env)
    enc = Encoder(8, generator=torch.Generator().manual_seed(0)).to(dtype)
    x = torch.randn((1, n, 3), generator=torch.Generator().manual_seed(1)).to(dtype)
    count = profiling.count
    calls = []
    monkeypatch.setattr(profiling, "count", lambda *a: calls.append(a) or count(*a))
    enc.trunk(x).sum().backward()
    assert calls == [] and profiling.totals() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        enc.trunk(x).sum().backward()
    assert profiling.totals() == {f"encoder.trunk_route.{route}": (1, 0.0)}


def test_adam_lowp_counts_the_values_it_updates_under_a_profiler_and_nowhere_else(monkeypatch):
    from hyperpocket_tpu_torch.train import optim

    params = [torch.nn.Parameter(torch.randn(9, 4)), torch.nn.Parameter(torch.randn(5))]
    opt = optim.make_optimizer({"type": "Adam", "hyperparams": {
        "lr": 1e-3, "moment_dtype": "bfloat16"}}, params)
    count = profiling.count
    calls = []
    monkeypatch.setattr(profiling, "count", lambda *a: calls.append(a) or count(*a))
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step()
    assert calls == [] and profiling.totals() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        opt.step()
        opt.step()
    assert profiling.totals() == {"adam_lowp.values": (2 * (36 + 5), 0.0)}
