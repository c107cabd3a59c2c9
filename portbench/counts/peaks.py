"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense,
without sparsity, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12

# the dense peak of each serving compute dtype
PEAK_OF_DTYPE = {"int8": INT8_OPS_PER_S, "bfloat16": BF16_FLOPS_PER_S,
                 "float32": FP32_FLOPS_PER_S}
