"""Public wrapper of the bitlinear CUDA kernel with backend selection.

``backend="auto"`` launches the kernel (``csrc/bitlinear.cu``) for CUDA
tensors and runs the plain version (``ref.py``) for CPU tensors.
``"cuda"`` and ``"reference"`` force one side and raise for a tensor on the
other device: nothing falls back.  ``LAUNCHES`` counts kernel launches by
weight precision, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from repro_torch.kernels.bitlinear.ref import bitlinear_matmul_ref

BACKENDS = ("auto", "reference", "cuda")
BITS = (2, 4, 8)
LAUNCHES: Dict[int, int] = {b: 0 for b in BITS}

_BK = 128                 # K values per step of the kernel's K loop
_BM, _BN = 16, 64         # output tile of one block
_sm_count: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    if device.index not in _sm_count:
        _sm_count[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sm_count[device.index]


def reset_launches() -> None:
    for b in BITS:
        LAUNCHES[b] = 0


def resolve_backend(backend: str, t: torch.Tensor) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    if backend == "auto":
        return "cuda" if t.is_cuda else "reference"
    if backend == "cuda" and not t.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors; got "
                         f"{t.device}")
    if backend == "reference" and t.is_cuda:
        raise ValueError(
            "backend='reference' runs the plain version on CPU tensors only; "
            "CUDA tensors go through the kernel")
    return backend


def _check(x: torch.Tensor, w: torch.Tensor, bits: int,
           out: Optional[torch.Tensor]) -> None:
    if bits not in BITS:
        raise ValueError(f"bits={bits}: expected one of {BITS}")
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} must "
                         "be 2-D")
    factor = 8 // bits
    if w.shape[0] * factor != x.shape[1]:
        raise ValueError(f"packed K {w.shape[0]}*{factor} != {x.shape[1]}")
    if out is not None and tuple(out.shape) != (x.shape[0], w.shape[1]):
        raise ValueError(f"out {tuple(out.shape)} != "
                         f"{(x.shape[0], w.shape[1])}")


def _launch(x: torch.Tensor, w: torch.Tensor, bits: int,
            out: Optional[torch.Tensor]) -> torch.Tensor:
    """C (+)= x @ unpack(w) on the card; returns C."""
    from repro_torch.kernels.build import library

    wdt = torch.int8 if bits == 8 else torch.uint8
    if x.dtype != torch.int8 or w.dtype != wdt:
        raise TypeError(f"kernel takes int8 x and {wdt} w at bits={bits}; "
                        f"got {x.dtype}, {w.dtype}")
    if x.device != w.device or (out is not None and out.device != x.device):
        raise ValueError("x, w and out must lie on one CUDA device")
    for name, t in (("x", x), ("w", w), ("out", out)):
        if t is not None and t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name} needs unit stride along its last axis")
    if out is not None and out.dtype != torch.int32:
        raise TypeError(f"out must be int32, got {out.dtype}")
    m, k = x.shape
    n = w.shape[1]
    accumulate = out is not None
    if out is None:
        out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    if m == 0 or n == 0:
        return out
    splits = 1
    if accumulate:
        # Spread K over enough blocks to fill the card twice; the kernel
        # adds the partial sums with integer atomics (exact in any order).
        tiles = math.ceil(m / _BM) * math.ceil(n / _BN)
        splits = max(1, min(math.ceil(k / _BK),
                            math.ceil(2 * sm_count(x.device) / tiles)))
    fn = library("bitlinear").bitlinear_launch
    if fn.argtypes is None:
        ll, vp, ci = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ll, vp, ll, vp, ll, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    rc = fn(x.data_ptr(), x.stride(0), w.data_ptr(), w.stride(0),
            out.data_ptr(), out.stride(0), m, n, k, bits, int(accumulate),
            splits, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bitlinear kernel launch failed: CUDA error {rc} "
                           f"(M={m} N={n} K={k} bits={bits})")
    LAUNCHES[bits] += 1
    return out


def bitlinear_matmul(
    x_int8: torch.Tensor,
    w_packed: torch.Tensor,
    *,
    bits: int = 2,
    backend: str = "auto",
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Integer GEMM with K-major packed weights: int32 ``x @ unpack(w)``.

    ``bits`` 2 or 4: ``w_packed`` is uint8 ``[K / (8 / bits), N]`` (see
    ``quant.packing``); ``bits=8``: ``w_packed`` is the int8 ``[K, N]``
    matrix itself.  With ``out`` the product is added into it in place
    (``out += x @ w``) and ``out`` is returned.
    """
    _check(x_int8, w_packed, bits, out)
    if resolve_backend(backend, x_int8) == "cuda":
        return _launch(x_int8, w_packed, bits, out)
    res = bitlinear_matmul_ref(x_int8, w_packed, bits=bits)
    if out is None:
        return res
    out += res
    return out


def tile_gemm(
    x_int8: torch.Tensor,
    w_packed: torch.Tensor,
    *,
    bits: int = 2,
    backend: str = "auto",
    out: Optional[torch.Tensor] = None,
    **_ignored,
) -> torch.Tensor:
    """Uniform tile-GEMM entry point (legion runtime contract).

    Any tile shape: the kernel masks ragged M, N and K edges, and takes
    strided views (unit stride along the last axis) without copying.
    """
    return bitlinear_matmul(x_int8, w_packed, bits=bits, backend=backend,
                            out=out)
