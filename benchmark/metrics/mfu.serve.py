"""The served model's FLOPs over the traced window (the benchmark's count,
``counts.model.serve_flops_a_cloud``, for every cloud completed there) as a
share of the compute dtype's published dense peak."""

from benchmark.counts import peaks

UNIT = "%"


def read(trace, counters):
    if trace is None or trace.busy_s <= 0 or counters.get("kind") != "serve" or not counters.get("calls"):
        return None
    return 100.0 * counters["flops"] / trace.window_s / peaks.DENSE_FLOPS[counters["dtype"]]
