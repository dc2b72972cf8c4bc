"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): HBM3 bandwidth and float32
outside the tensor cores.  A share of a roofline is stated against
these, with the card's power limit printed beside it."""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the bandwidth and the operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
