"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit): the roofline every
share of a peak in this benchmark is taken against."""

BF16_FLOPS = 989e12         # FLOP/s, bf16 and fp16 on the tensor cores
HBM_BYTES = 3.35e12         # bytes/s


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the bf16 peak and the bytes over the HBM rate."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)
