"""Public wrappers of the block-sparse (ZTB) CUDA kernel.

``backend="auto"`` launches the kernel (``csrc/block_sparse.cu``) for CUDA
tensors and runs the plain version (``ref.py``) for CPU tensors;
``"cuda"`` and ``"reference"`` force one side and raise for a tensor on the
other device: nothing falls back.  The CSR-of-blocks schedule is built on
the host (:func:`repro_torch.core.sparsity.csr_block_schedule`) and
uploaded.  ``LAUNCHES`` counts kernel launches by operand type, so a run can
show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sparsity import csr_block_schedule
from repro_torch.kernels.bitlinear.ops import resolve_backend, sm_count
from repro_torch.kernels.block_sparse.ref import block_sparse_matmul_ref

DTYPES = {torch.int8: ("int8", 0, torch.int32),
          torch.float32: ("float32", 1, torch.float32)}
LAUNCHES: Dict[str, int] = {name: 0 for name, _, _ in DTYPES.values()}
KERNEL_BN = 64            # output columns of one block of the kernel


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def block_mask(w: np.ndarray, *, bk: int, bn: int) -> np.ndarray:
    """bool [ceil(K/bk), ceil(N/bn)]: which blocks of ``w`` [K, N] hold a
    non-zero (the offline ZTB build; ragged edge blocks included)."""
    k, n = w.shape
    kt, nt = -(-k // bk), -(-n // bn)
    nz = np.zeros((kt * bk, nt * bn), dtype=bool)
    nz[:k, :n] = np.asarray(w) != 0
    return nz.reshape(kt, bk, nt, bn).any(axis=(1, 3))


def schedule(block_nonzero: np.ndarray, device: torch.device
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's schedule of a block mask on ``device``: int32
    ``indices [NT, S]`` (trimmed to the densest column, S >= 1) and
    ``counts [NT]``."""
    indices, counts = csr_block_schedule(np.asarray(block_nonzero))
    s = max(int(counts.max(initial=0)), 1)
    trimmed = np.zeros((indices.shape[0], s), dtype=np.int32)
    trimmed[:, :min(s, indices.shape[1])] = indices[:, :s]
    return (torch.from_numpy(trimmed).to(device),
            torch.from_numpy(counts).to(device))


def _schedule_mask(indices: torch.Tensor, counts: torch.Tensor,
                   kt: int) -> np.ndarray:
    idx, cnt = indices.cpu().numpy(), counts.cpu().numpy()
    mask = np.zeros((kt, len(cnt)), dtype=bool)
    for j, c in enumerate(cnt):
        mask[idx[j, :c], j] = True
    return mask


def _launch(x: torch.Tensor, w: torch.Tensor, indices: torch.Tensor,
            counts: torch.Tensor, bk: int, bn: int,
            out: Optional[torch.Tensor]) -> torch.Tensor:
    """C (+)= x @ w over the scheduled blocks, on the card; returns C."""
    from repro_torch.kernels.build import library

    if x.dtype != w.dtype or x.dtype not in DTYPES:
        raise TypeError("kernel takes int8 x int8 or float32 x float32 "
                        f"operands; got {x.dtype}, {w.dtype}")
    name, code, out_dtype = DTYPES[x.dtype]
    if out is not None and out.dtype != out_dtype:
        raise TypeError(f"out must be {out_dtype}, got {out.dtype}")
    tensors = (("x", x), ("w", w), ("out", out), ("indices", indices),
               ("counts", counts))
    if any(t is not None and t.device != x.device for _, t in tensors):
        raise ValueError("x, w, out and the schedule must lie on one CUDA "
                         "device")
    for label, t in tensors:
        if t is not None and t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{label} needs unit stride along its last "
                             "axis")
    if indices.dtype != torch.int32 or counts.dtype != torch.int32:
        raise TypeError("the schedule must be int32")
    m, k = x.shape
    n = w.shape[1]
    accumulate = out is not None
    if out is None:
        out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    s = indices.shape[1]
    splits = 1
    if accumulate and code == 0:
        # Spread the schedule entries over enough blocks to fill the card
        # twice; the kernel adds the partial sums with integer atomics.
        bm = 64 if m > 32 else 16
        tiles = counts.shape[0] * math.ceil(bn / KERNEL_BN) * math.ceil(m / bm)
        splits = max(1, min(s, math.ceil(2 * sm_count(x.device) / tiles)))
    fn = library("block_sparse").block_sparse_launch
    if fn.argtypes is None:
        ll, vp, ci = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, vp, ll, vp, ll, vp, ll, ci, ci, ci, vp, ci, vp,
                       ci, ci, ci, ci, vp]
        fn.restype = ci
    rc = fn(code, x.data_ptr(), x.stride(0), w.data_ptr(), w.stride(0),
            out.data_ptr(), out.stride(0), m, n, k, indices.data_ptr(),
            indices.stride(0), counts.data_ptr(), bk, bn, int(accumulate),
            splits, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"block_sparse kernel launch failed: CUDA error "
                           f"{rc} (M={m} N={n} K={k} bk={bk} bn={bn} "
                           f"{name})")
    LAUNCHES[name] += 1
    return out


def block_sparse_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    indices: torch.Tensor,
    counts: torch.Tensor,
    *,
    bk: int,
    bn: int,
    backend: str = "auto",
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``out[M, N] = x[M, K] @ w[K, N]`` visiting, for each column block
    ``j`` (``bn`` columns), only the ``counts[j]`` K blocks (``bk`` rows)
    listed in ``indices[j]`` — a schedule from :func:`schedule`.  Ragged
    edge blocks are allowed.  With ``out`` the product is added into it in
    place (``out += ...``) and ``out`` is returned.
    """
    k, n = w.shape
    if x.ndim != 2 or x.shape[1] != k:
        raise ValueError(f"x {tuple(x.shape)} vs w {tuple(w.shape)}")
    if counts.shape[0] != -(-n // bn) or indices.shape[0] != counts.shape[0]:
        raise ValueError(f"schedule of {counts.shape[0]} columns for N={n} "
                         f"at bn={bn}")
    if out is not None and tuple(out.shape) != (x.shape[0], n):
        raise ValueError(f"out {tuple(out.shape)} != {(x.shape[0], n)}")
    if resolve_backend(backend, x) == "cuda":
        return _launch(x, w, indices, counts, bk, bn, out)
    res = block_sparse_matmul_ref(
        x, w, _schedule_mask(indices, counts, -(-k // bk)), bk=bk, bn=bn)
    if out is None:
        return res
    out += res
    return out


def ztb_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    block_nonzero: np.ndarray,
    *,
    bm: int = 128,
    bn: int = 128,
    bk: int = 128,
    backend: str = "auto",
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Block-sparse matmul skipping ZTB-zero blocks.

    ``block_nonzero`` is a static (offline, per the paper) numpy bool mask
    of shape [K//bk, N//bn].  ``bm`` is kept for the reference's signature:
    the kernel tiles M itself and masks the ragged edge.
    """
    del bm
    if resolve_backend(backend, x) == "cuda":
        indices, counts = schedule(block_nonzero, x.device)
        return block_sparse_matmul(x, w, indices, counts, bk=bk, bn=bn,
                                   backend="cuda", out=out)
    res = block_sparse_matmul_ref(x, w, block_nonzero, bk=bk, bn=bn)
    if out is None:
        return res
    out += res
    return out


def tile_gemm(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    block_nonzero: Optional[np.ndarray] = None,
    bm: int = 128,
    bn: int = 128,
    bk: int = 128,
    backend: str = "auto",
    out: Optional[torch.Tensor] = None,
    **_ignored,
) -> torch.Tensor:
    """Uniform tile-GEMM entry point (legion runtime contract).

    ``w`` arrives dense; if no ZTB mask is supplied one is derived from the
    actual zero blocks of ``w`` (the offline ZTB build).  A supplied mask is
    applied to ``w`` up front (at the mask's own block granularity), so the
    shape fallback below can re-derive blocks without ever resurrecting a
    pruned-but-nonzero block.  Block shapes fall back to the whole tile when
    the runtime's window/slice geometry does not divide the defaults —
    semantics are unchanged, only skip granularity.
    """
    k, n = w.shape
    if block_nonzero is not None:
        mk, mn = block_nonzero.shape
        expanded = np.repeat(
            np.repeat(np.asarray(block_nonzero), -(-k // mk), axis=0),
            -(-n // mn), axis=1,
        )[:k, :n]
        w = w * torch.from_numpy(expanded).to(device=w.device, dtype=w.dtype)
    if k % bk or n % bn:
        bk, bn = k, n
    nz = (w.reshape(k // bk, bk, n // bn, bn) != 0).any(dim=3).any(dim=1)
    return ztb_matmul(x, w, nz.cpu().numpy(), bm=bm, bn=bn, bk=bk,
                      backend=backend, out=out)
