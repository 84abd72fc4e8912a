"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit)."""

BF16_FLOPS = 989e12      # bf16/fp16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time of a piece of work: its operations at the bf16 peak
    against its bytes at HBM's rate."""
    return max(ops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
