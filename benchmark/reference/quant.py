"""The lower precisions of the controls: each rounds an fp32 tensor to the
values the lower format holds and returns it in fp32."""

from __future__ import annotations

import torch

FP8_E4M3_MAX = 448.0


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round to TF32 (10 explicit mantissa bits), to nearest, ties away from
    zero, as the tensor cores round fp32 operands."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """fp8 e4m3 with one scale a tensor (its largest magnitude onto 448)."""
    x = x.float()
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale
