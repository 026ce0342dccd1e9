"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity), at the card's full 700 W power limit."""

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12  # outside the tensor cores: TF32 is off in every fp32 cell
FP32_LANE_RATE = FP32_FLOPS / 2  # fp32 instructions a second (an FMA is 2 FLOPs)
HBM_BYTES_S = 3.35e12

DENSE_FLOPS = {"bfloat16": BF16_FLOPS, "float32": FP32_FLOPS}
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}
