"""bitlinear: int8 x K-major packed sub-byte weights, exact int32 GEMM."""
