"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit). The rooflines and step shares use the TF32
tensor-core rate: no product that keeps the cells' float32 agreement runs
faster (split TF32 reaches at most a third of it; a plain TF32 or bf16
product fails the precision control), so no share can pass 100%."""

TF32_FLOP_S = 495e12
HBM_BYTE_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations at
    the TF32 peak and the bytes at the memory's peak."""
    return max(flops / TF32_FLOP_S, nbytes / HBM_BYTE_S)
