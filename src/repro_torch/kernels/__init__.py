"""Hand-written CUDA kernels for the paper's compute hot-spots.

Each kernel subpackage ships ``ref.py`` (the plain PyTorch version) and
``ops.py`` (the public wrapper with ``backend="auto"|"reference"|"cuda"``,
and ``"naive"`` for the SSD recurrence);
the CUDA sources live in ``src/repro_torch/csrc/`` and are built by
:mod:`repro_torch.kernels.build` at first use.

- bitlinear: int8 activations x K-major packed 2/4-bit (or int8) weights,
             exact int32 accumulation (``csrc/bitlinear.cu``)
- block_sparse: ZTB block-sparse GEMM that visits only the non-zero
             weight blocks of a CSR-of-blocks schedule; int8 -> exact int32
             or float32 (``csrc/block_sparse.cu``)
- ssd:       the Mamba-2 chunked SSD scan, the state carried on chip
             across chunks, terminal state on request (``csrc/ssd.cu``),
             and its gradient (``csrc/ssd_bwd.cu``)
- flash_attention: online-softmax attention, causal or full, GQA,
             float32 or bfloat16 (``csrc/flash_attention.cu``)

The dense backend of the runtime's uniform ``tile_gemm(x, w, **kw)``
contract lives here as :func:`dense_tile_gemm`, and its grouped
counterpart for integer operands as :func:`dense_grouped_tile_gemm`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels.bitlinear import ops as _bitlinear


def dense_tile_gemm(x: torch.Tensor, w: torch.Tensor, *,
                    backend: str = "auto",
                    out: Optional[torch.Tensor] = None,
                    **_ignored) -> torch.Tensor:
    """``out[M, N] = x[M, K] @ w[K, N]`` — the dense backend.

    Integer operands accumulate in int32 (the PE datapath) through the
    bitlinear kernel at ``bits=8`` on CUDA tensors (int8 operands; the only
    int8 product on the card that takes M = 1) and through its plain
    version on CPU tensors.  Floats multiply in float32 with
    ``torch.matmul``.  With ``out`` the product is added into it in place.
    """
    if not (x.dtype.is_floating_point or w.dtype.is_floating_point):
        return _bitlinear.tile_gemm(x, w, bits=8, backend=backend, out=out)
    res = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    if out is None:
        return res
    out += res
    return out


def dense_grouped_tile_gemm(x: torch.Tensor, w: torch.Tensor,
                            out: torch.Tensor, slices: Sequence, *,
                            backend: str = "auto") -> None:
    """``out[i, :, lo:hi] += x[i] @ w[i][:, lo:hi]`` for every ``(i, lo,
    hi)`` of ``slices``: integer operands, int32 outputs, one bitlinear
    kernel launch at ``bits=8`` for the whole group on CUDA tensors (its
    plain version on CPU tensors).  Float operands raise: they take
    :func:`dense_tile_gemm` one product at a time, in the reference's
    order."""
    if x.dtype.is_floating_point or w.dtype.is_floating_point:
        raise TypeError("the grouped dense path takes integer operands; "
                        f"got {x.dtype}, {w.dtype}")
    _bitlinear.grouped_tile_gemm(x, w, out, slices, bits=8, backend=backend)
