"""K9 (``ops/nn.py::chamfer_loss_fused``, the training loss's Chamfer value
and gradient on the card's "k9" route): its sweep's least time
(``counts.model.k9_chamfer_bound_s``, 14 instructions a pair) over the device
time of its kernels (the word fill, the sweep and the two gradient passes)
in the traced training window; nothing where the route is another."""

from benchmark.counts import model

UNIT = "%"
KERNELS = ("chamfer_direction1", "chamfer_direction2", "nn_fused_kernel", "fill_words")


def read(trace, counters):
    if trace is None or counters.get("kind") != "train":
        return None
    launches, _ = trace.kernel_seconds(KERNELS[0])
    _, seconds = trace.kernel_seconds(*KERNELS)
    if not launches or seconds <= 0:
        return None
    bound = model.k9_chamfer_bound_s(counters["batch"], counters["n_gt"], counters["n_gt"])
    return 100.0 * launches * bound / seconds
