"""K4 (``ops/trunk_pool.py::trunk_pooled``, the bf16 encoder trunk): its
least time (``counts.model.k4_trunk_bound_s`` a launch at the call's batch
and points) over the device time of its kernels in the traced window (the
trunk kernel and the op's fill and cast)."""

from benchmark.counts import model

UNIT = "%"
KERNELS = ("trunk_pool_kernel", "fill_neg_inf", "cast_to_bf16")


def read(trace, counters):
    if trace is None or counters.get("kind") != "serve":
        return None
    launches, _ = trace.kernel_seconds(KERNELS[0])
    _, seconds = trace.kernel_seconds(*KERNELS)
    if not launches or seconds <= 0:
        return None
    bound = model.k4_trunk_bound_s(counters["batch"], counters["n_existing"])
    return 100.0 * launches * bound / seconds
