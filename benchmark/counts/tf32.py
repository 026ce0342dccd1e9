"""The TF32 dense peak of one NVIDIA H100 SXM, at the card's full 700 W
power limit: NVIDIA's H100 data sheet gives the TF32 tensor core 989
TFLOP/s with sparsity, so 494.7 dense. ``peaks.FP32_FLOPS`` (67 TFLOP/s)
is fp32 outside the tensor cores, the peak of the cells that keep TF32 off;
a cell whose fp32 matmuls run TF32 (``matmul_precision`` "high") reads its
share of this peak (``metrics/mfu.train_tf32.py``)."""

TF32_FLOPS = 494.7e12
