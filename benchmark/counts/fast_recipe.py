"""The least times of the two kernels that only the bf16 training recipe
runs (``settings/config_3depn_chair_fast.json``): K8, the training trunk's
fused forward and argmax, and ``adam_lowp``, Adam with bf16 moments."""

from __future__ import annotations

from benchmark.counts import model


def k8_trunk_bound_s(batch: int, n: int) -> float:
    """K8 (``trunk_pooled_argmax``, bf16): K4's work
    (``model.k4_trunk_bound_s``), the same five layers on the same rows;
    its epilogue keeps a 64-bit key a (cloud, channel), which adds no
    operation a point and under a thousandth of the bytes."""
    return model.k4_trunk_bound_s(batch, n)


def adam_lowp_bytes_a_value(param_bytes: int = 4, moment_bytes: int = 2) -> int:
    """One value's traffic: the parameter read and written and its gradient
    read, both moments read and written (20 bytes for fp32 parameters and
    bf16 moments)."""
    return 3 * param_bytes + 4 * moment_bytes


def adam_lowp_bound_s(values: float, param_bytes: int = 4, moment_bytes: int = 2) -> float:
    """``adam_lowp`` over ``values`` values: bytes at the HBM rate (a handful
    of operations a value is nothing beside them)."""
    return model.bound_s(values * adam_lowp_bytes_a_value(param_bytes, moment_bytes), 0.0)
