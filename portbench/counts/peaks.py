"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W power limit; a card set below it runs slower under load)."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # float32 outside the tensor cores


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time of work on one card: the larger of its operations
    over the float32 peak and its bytes over the HBM bandwidth."""
    return max(ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
