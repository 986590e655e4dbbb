"""Peak rates of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit).  A share of a peak is stated against these, with the card's
power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12        # tensor cores, bf16 / fp16 operands
TF32_OPS_PER_S = 495e12        # tensor cores, float32 operands as TF32

# operand element size in bytes -> the tensor-core peak of that precision
OPS_PER_S_BY_ELT = {2: BF16_OPS_PER_S, 4: TF32_OPS_PER_S}


def bound_s(ops: float, nbytes: float, elt: int) -> float:
    """The least time the card could take: the larger of the operations
    over the tensor-core peak of the operands' precision and the bytes over
    HBM bandwidth."""
    return max(ops / OPS_PER_S_BY_ELT[elt], nbytes / HBM_BYTES_PER_S)
