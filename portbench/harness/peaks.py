"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the 700 W power limit) and the roofline bound of one piece of work."""

BF16_FLOP_PER_S = 989e12            # bf16 tensor cores
F32_FLOP_PER_S = 67e12              # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12           # HBM3


def bound_s(nbytes: float, flops: float, flop_rate: float = BF16_FLOP_PER_S) -> float:
    """The least time the card could take: the larger of the operations at
    the peak rate and the bytes at the memory's bandwidth."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_rate)
