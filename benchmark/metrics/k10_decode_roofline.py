"""K10 (``ops/decoder.py::decode_batch``, the target-network decode of the
inference forward): its least time (``counts.model.k10_decode_bound_s``, 18,720
MACs a point for the chair decoder) over its kernels' device time in the
traced serving window."""

from benchmark.counts import model

UNIT = "%"
KERNELS = ("decode_batch_tc_kernel", "decode_batch_kernel")


def read(trace, counters):
    if trace is None or counters.get("kind") != "serve":
        return None
    launches, seconds = trace.kernel_seconds(*KERNELS)
    if not launches or seconds <= 0:
        return None
    chans = counters["model"]["target_network"]["layer_out_channels"]
    bound = model.k10_decode_bound_s(counters["batch"], counters["n_out"], chans,
                                     counters["dtype"])
    return 100.0 * launches * bound / seconds
