"""block_sparse: ZTB-driven block-sparse GEMM over a CSR-of-blocks schedule."""
