"""Plain PyTorch version of the bitlinear kernel."""
from __future__ import annotations

import torch

from repro_torch.quant.packing import unpack_2bit_kmajor, unpack_4bit_kmajor


def unpack_weights(w_packed: torch.Tensor, bits: int) -> torch.Tensor:
    """K-major packed weights -> int8 [K, N] (bits 8: the int8 matrix)."""
    if bits == 2:
        return unpack_2bit_kmajor(w_packed)
    if bits == 4:
        return unpack_4bit_kmajor(w_packed)
    if bits == 8:
        return w_packed
    raise ValueError(f"bits={bits}")


def int_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact ``x @ w`` of integer matrices, wrapped to int32.

    CPU: int64 matmul.  CUDA has no integer matmul, so there the product
    runs in float64, which is exact while every partial sum stays below
    2^53 (int8 operands: K < 2^39).
    """
    if x.is_cuda:
        out = (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int64)
    else:
        out = x.to(torch.int64) @ w.to(torch.int64)
    return out.to(torch.int32)


def bitlinear_matmul_ref(
    x: torch.Tensor, w_packed: torch.Tensor, *, bits: int = 2,
) -> torch.Tensor:
    """out[M, N] = x[M, K] @ unpack(w_packed)[K, N], int32 accumulation."""
    return int_matmul(x, unpack_weights(w_packed, bits))


def grouped_tile_gemm_ref(x, w, out, slices, *, bits: int) -> None:
    """``out[i, :, lo:hi] += x[i] @ unpack(w[i][:, lo:hi])`` for every
    ``(i, lo, hi)`` of ``slices``, one after another (``x`` or ``w`` without
    an instance axis is shared): the plain version of the grouped kernel."""
    for i, lo, hi in slices:
        xi = x[i] if x.ndim == 3 else x
        wi = w[i] if w.ndim == 3 else w
        out[i, :, lo:hi] += bitlinear_matmul_ref(xi, wi[:, lo:hi], bits=bits)
