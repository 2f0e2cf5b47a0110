"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

BF16_FLOPS = 989e12   # bf16 and fp16 on the tensor cores
TF32_FLOPS = 495e12   # TF32 on the tensor cores: the highest rate f32 inputs are multiplied at
F32_FLOPS = 67e12     # f32 outside the tensor cores
HBM_BYTES = 3.35e12   # HBM3 bandwidth, bytes/s


def least_seconds(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory bandwidth."""
    return max(flops / peak_flops, nbytes / HBM_BYTES)
