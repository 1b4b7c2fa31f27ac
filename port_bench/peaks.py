"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
full 700 W power limit; a card set lower reaches less, so every run records
the card's limit beside its numbers), and the roofline bound of a piece of
work against them."""

#: float32 operations per second outside the tensor cores (the port's
#: kernels run float32 FMAs; no TF32) and HBM3 bytes per second.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: operations over the float32 peak
    or bytes over the memory rate, whichever is larger."""
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)
