"""Host ms of the CUDA-graph captures an epoch (``EpochScan.capture_ms`` of
the Trainer's train and val epoch functions, summed), the mean over the
window's epochs: the learning rate is a float in the captured kernels, so
every epoch captures both graphs anew."""

UNIT = "ms"


def read(trace, counters):
    if counters.get("kind") != "train" or not counters.get("capture_ms"):
        return None
    values = [v for v in counters["capture_ms"] if v > 0]
    return sum(values) / len(values) if values else None
