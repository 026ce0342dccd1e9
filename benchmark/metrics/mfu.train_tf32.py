"""The FLOPs of every train and val step of the traced window's epochs
(``counts.model.train_flops_a_cloud`` and ``val_flops_a_cloud``, as
``mfu.train``) as a share of the TF32 dense peak (``counts/tf32.py``), in a
cell whose program ran fp32 with TF32 matmuls: the counters of
``traffic/train_epochs_tf32.py``, which reads ``compute_dtype`` and
``matmul_precision`` from the program."""

from benchmark.counts import tf32

UNIT = "%"


def read(trace, counters):
    if (trace is None or trace.busy_s <= 0 or counters.get("kind") != "train"
            or not counters.get("window_epochs") or counters.get("compute_dtype") != "float32"
            or counters.get("matmul_precision") != "high"):
        return None
    return 100.0 * counters["flops"] / trace.window_s / tf32.TF32_FLOPS
