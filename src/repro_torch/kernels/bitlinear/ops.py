"""Public wrapper of the bitlinear CUDA kernel with backend selection.

``backend="auto"`` launches the kernel (``csrc/bitlinear.cu``) for CUDA
tensors and runs the plain version (``ref.py``) for CPU tensors.
``"cuda"`` and ``"reference"`` force one side and raise for a tensor on the
other device: nothing falls back.  ``LAUNCHES`` counts kernel launches by
weight precision, so a run can show that its path went through the kernel.
The kernel has no backward (QAT multiplies through fake-quant, never
through it): a CUDA call whose float operands need a gradient raises.

One kernel serves single products and groups of them:
:func:`grouped_tile_gemm` adds a work list of column slices into one
accumulator with one launch (a Legion stage's assignments), and
:func:`bitlinear_matmul` / :func:`tile_gemm` are a group of one.
"""
from __future__ import annotations

import array
import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import on_card
from repro_torch.kernels.bitlinear.ref import (
    bitlinear_matmul_ref, grouped_tile_gemm_ref,
)

BACKENDS = ("auto", "reference", "cuda")
BITS = (2, 4, 8)
LAUNCHES: Dict[int, int] = {b: 0 for b in BITS}

# one product of a group: (instance, first column, end column)
Slice = Tuple[int, int, int]

_sm_count: Dict[int, int] = {}
_entry = None             # the C entry point, resolved at first launch


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    if device.index not in _sm_count:
        _sm_count[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sm_count[device.index]


def raw_stream(device: torch.device) -> int:
    """The handle of PyTorch's current CUDA stream on ``device``, through
    the private accessor (a fraction of a microsecond, against several for
    ``torch.cuda.current_stream``)."""
    return torch._C._cuda_getCurrentRawStream(
        device.index if device.index is not None
        else torch.cuda.current_device())


def reset_launches() -> None:
    for b in BITS:
        LAUNCHES[b] = 0


def resolve_backend(backend: str, t: torch.Tensor) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    if backend == "auto":
        return "cuda" if on_card(t) else "reference"
    if backend == "cuda" and not on_card(t):
        raise ValueError("backend='cuda' needs CUDA tensors; got "
                         f"{t.device}")
    if backend == "reference" and t.is_cuda:
        raise ValueError(
            "backend='reference' runs the plain version on CPU tensors only; "
            "CUDA tensors go through the kernel")
    return backend


def refuse_grad(kernel: str, item: str, *tensors) -> None:
    """Raise if autograd would have to differentiate through ``kernel``'s
    CUDA launch: its output is a fresh tensor that a ctypes call fills, with
    no ``grad_fn``, so the gradient would stop there without a word.
    ``item`` names the ROADMAP.md entry that gives the kernel a backward.
    The plain version is not taken instead: that would hide the kernel."""
    if torch.is_grad_enabled() and any(
            t is not None and t.is_floating_point() and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"the {kernel} CUDA kernel has no backward yet ({item}); run "
            "it under torch.no_grad() or on inputs that need no gradient")


NO_BACKWARD = "ROADMAP.md Queue 1, item 4: the integer kernels' backward"


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


def _launch_fn():
    global _entry
    if _entry is None:
        from repro_torch.kernels.build import library

        fn = library("bitlinear").bitlinear_grouped_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ci, ci, ci, ci, vp]
        fn.restype = ci
        _entry = fn
    return _entry


def _run(desc: List[int], count: int, bits: int, accumulate: bool,
         device: torch.device) -> None:
    """Launch the kernel on ``count`` products described in ``desc`` (9
    integers each, see ``bitlinear_grouped_launch``) on ``device``."""
    table = array.array("q", desc)
    rc = _launch_fn()(table.buffer_info()[0], count, bits, int(accumulate),
                      sm_count(device), raw_stream(device))
    if rc < 0:
        raise RuntimeError(f"bitlinear kernel launch failed: CUDA error {-rc} "
                           f"({count} products, bits={bits})")
    LAUNCHES[bits] += rc


def _check_kernel_operands(tensors, bits: int) -> None:
    """The kernel's dtypes, one CUDA device, unit stride along each last
    axis."""
    x, w, out = tensors
    wdt = torch.int8 if bits == 8 else torch.uint8
    if x.dtype != torch.int8 or w.dtype != wdt or out.dtype != torch.int32:
        raise TypeError(f"kernel takes int8 x, {wdt} w and int32 out at "
                        f"bits={bits}; got {x.dtype}, {w.dtype}, {out.dtype}")
    if not (x.get_device() == w.get_device() == out.get_device() >= 0):
        raise ValueError("x, w and out must lie on one CUDA device")
    for name, t in (("x", x), ("w", w), ("out", out)):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} needs unit stride along its last axis")


def grouped_tile_gemm(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
                      slices: Sequence[Slice], *, bits: int,
                      backend: str = "auto") -> None:
    """``out[i, :, lo:hi] += x[i] @ unpack(w[i][:, lo:hi])`` for every
    ``(i, lo, hi)`` of ``slices``, as one kernel launch (a Legion stage's
    assignments).

    ``x`` is ``[M, K]`` (shared by every instance) or ``[I, M, K]`` int8;
    ``w`` is ``[K / (8 / bits), N]`` (shared) or ``[I, K / (8 / bits),
    N]``, packed as for :func:`bitlinear_matmul`; ``out`` is ``[I, M, N]``
    int32.  Each operand may be a strided view with unit stride along its
    last axis.  Slices may be ragged, empty or overlap: the kernel adds
    with integer atomics, so the result equals the slices' products added
    one after another.  The operands are checked once for the group;
    CPU tensors run the plain version, the same per-slice loop.
    """
    if bits not in BITS:
        raise ValueError(f"bits={bits}: expected one of {BITS}")
    if x.ndim not in (2, 3) or w.ndim not in (2, 3) or out.ndim != 3:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}, out "
                         f"{tuple(out.shape)}: expected [(I,) M, K], "
                         "[(I,) K', N], [I, M, N]")
    count, m, n = out.shape
    k = x.shape[-1]
    if w.shape[-2] * (8 // bits) != k:
        raise ValueError(f"packed K {w.shape[-2]}*{8 // bits} != {k}")
    if x.shape[-2] != m or w.shape[-1] != n or any(
            t.ndim == 3 and t.shape[0] != count for t in (x, w)):
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         f"match out {tuple(out.shape)}")
    for i, lo, hi in slices:
        if not (0 <= i < count and 0 <= lo <= hi <= n):
            raise ValueError(f"slice {(i, lo, hi)} outside out "
                             f"{tuple(out.shape)}")
    if resolve_backend(backend, x) == "reference":
        if w.is_cuda or out.is_cuda:
            raise ValueError("a group's tensors must all lie on the CPU or "
                             "all on the card")
        grouped_tile_gemm_ref(x, w, out, slices, bits=bits)
        return
    refuse_grad("bitlinear", NO_BACKWARD, x, w, out)
    _check_kernel_operands((x, w, out), bits)
    if not slices:
        return
    xs = x.stride(0) if x.ndim == 3 else 0
    ws = w.stride(0) if w.ndim == 3 else 0
    lda, ldb, os0, ldc = x.stride(-2), w.stride(-2), out.stride(0), \
        out.stride(1)
    xp, wp, op = x.data_ptr(), w.data_ptr(), out.data_ptr()
    desc = []
    for i, lo, hi in slices:
        # int8 / uint8 operands: one byte an element; int32 out: four
        desc += (xp + i * xs, lda, wp + i * ws + lo, ldb,
                 op + 4 * (i * os0 + lo), ldc, m, hi - lo, k)
    _run(desc, len(slices), bits, True, x.device)


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
        refuse_grad("bitlinear", NO_BACKWARD, x_int8, w_packed, out)
        accumulate = out is not None
        if out is None:
            out = torch.empty((x_int8.shape[0], w_packed.shape[1]),
                              dtype=torch.int32, device=x_int8.device)
        _check_kernel_operands((x_int8, w_packed, out), bits)
        _run([x_int8.data_ptr(), x_int8.stride(0), w_packed.data_ptr(),
              w_packed.stride(0), out.data_ptr(), out.stride(0),
              x_int8.shape[0], w_packed.shape[1], x_int8.shape[1]], 1, bits,
             accumulate, x_int8.device)
        return out
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


def bitlinear_apply(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    w_scale: torch.Tensor,
    *,
    bits: int = 2,
    backend: str = "auto",
) -> torch.Tensor:
    """The full BitLinear serving op: quantize the activations (per-row
    absmax int8), integer GEMM through :func:`bitlinear_matmul` (the kernel
    for CUDA tensors, its plain version for CPU tensors), dequantize by the
    activations' and the weights' scales.

    x float ``[M, K]``, ``w_packed`` as :func:`bitlinear_matmul` takes it,
    ``w_scale`` the weights' scale -> float ``[M, N]`` in x's type.
    """
    s = torch.amax(torch.abs(x), dim=-1, keepdim=True) / 127.0 + 1e-5
    xq = torch.clamp(torch.round(x / s), -128, 127).to(torch.int8)
    acc = bitlinear_matmul(xq, w_packed, bits=bits, backend=backend)
    return acc.to(x.dtype) * (s * w_scale).to(x.dtype)
