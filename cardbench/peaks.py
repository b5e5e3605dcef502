"""Peak rates of one NVIDIA H100 SXM (the data sheet, at its 700 W limit):
HBM3 bandwidth and dense float32 outside the tensor cores. A roofline share
is the least time for a stage's work at these rates over its measured time;
the run prints the card's power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def least_seconds(ops: float, nbytes: float) -> float:
    """The larger of the bytes over the memory rate and the operations over
    the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
