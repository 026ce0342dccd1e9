"""K8 (``ops/trunk_pool.py::trunk_pooled_argmax``, the bf16 training
trunk's forward and argmax on the card's "k8" route,
``models/encoder.py::trunk_grad_route``): its least time
(``counts.fast_recipe.k8_trunk_bound_s`` a launch, at the batch and the
partial clouds' points) over the device time of its kernels in the traced
training window: the trunk kernel's argmax instantiation and the key fill
and unpack. K4's instantiation (``trunk_pool_kernel<false>``, the val
epoch's inference trunk) is left out."""

from benchmark.counts import fast_recipe

UNIT = "%"
KERNELS = ("trunk_pool_kernel<true>", "fill_zero_keys", "unpack_keys")


def read(trace, counters):
    if trace is None or counters.get("kind") != "train":
        return None
    launches, _ = trace.kernel_seconds(KERNELS[0])
    _, seconds = trace.kernel_seconds(*KERNELS)
    if not launches or seconds <= 0:
        return None
    bound = fast_recipe.k8_trunk_bound_s(counters["batch"], counters["n_partial"])
    return 100.0 * launches * bound / seconds
