"""The FLOPs of every train and val step of the traced window's epochs
(``counts.model.train_flops_a_cloud`` and ``val_flops_a_cloud``, as
``mfu.train``) as a share of the bf16 dense peak, in a cell that trains in
bf16 (``traffic/train_epochs_bf16.py`` counts its epochs as
``window_epochs``)."""

from benchmark.counts import peaks

UNIT = "%"


def read(trace, counters):
    if (trace is None or trace.busy_s <= 0 or counters.get("kind") != "train"
            or not counters.get("window_epochs") or counters.get("compute_dtype") != "bfloat16"):
        return None
    return 100.0 * counters["flops"] / trace.window_s / peaks.BF16_FLOPS
