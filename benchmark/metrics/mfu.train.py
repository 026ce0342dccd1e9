"""The FLOPs of every train and val step of the traced window's epochs
(``counts.model.train_flops_a_cloud`` and ``val_flops_a_cloud``) as a share
of the fp32 dense peak: the configuration trains in fp32 with TF32 off."""

from benchmark.counts import peaks

UNIT = "%"


def read(trace, counters):
    if trace is None or trace.busy_s <= 0 or counters.get("kind") != "train" or not counters.get("epochs"):
        return None
    return 100.0 * counters["flops"] / trace.window_s / peaks.FP32_FLOPS
