"""``adam_lowp`` (``ops/adam_lowp.py``, Adam with bf16 moments, one kernel
a tensor): the window's train steps' least time, 20 bytes a value at the
HBM rate (``counts.fast_recipe.adam_lowp_bound_s``), over the device time
of ``adam_lowp_kernel`` in the traced training window.

The values a step are the program's counter ``adam_lowp.values``
(``utils/profiling.py``), which counts a step's tensors where the update
launches: in a scanned epoch once, at the capture of the train step, so
the counter over the window's epochs is a step's values. Where the
program has no such counter, nothing is read."""

from benchmark.counts import fast_recipe

UNIT = "%"
KERNEL = "adam_lowp_kernel"


def read(trace, counters):
    if trace is None or counters.get("kind") != "train" or not counters.get("window_epochs"):
        return None
    try:
        from hyperpocket_tpu_torch.utils.profiling import totals
    except ImportError:
        return None
    values = totals().get("adam_lowp.values", (0, 0.0))[0]
    launches, seconds = trace.kernel_seconds(KERNEL)
    if not values or not launches or seconds <= 0:
        return None
    a_step = values / counters["window_epochs"]
    return 100.0 * fast_recipe.adam_lowp_bound_s(a_step * counters["steps"]) / seconds
