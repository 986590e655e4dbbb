"""Public wrapper of the flash-attention CUDA kernels: ``[B, H, S, d]``
layout, backend selection and the gradient.

``backend="auto"`` launches the kernel (``csrc/flash_attention.cu``) for
CUDA tensors and runs the plain version (``ref.py``) for CPU tensors;
``"cuda"`` and ``"reference"`` force one side and raise for a tensor on the
other device: nothing falls back.  bfloat16 runs the tensor-core kernel,
which loads q, k and v by TMA; a bf16 call whose layout TMA cannot read
(``tma_layout_error``) raises.  The bf16 backward loads q, k, v and dout
by TMA too and raises on q, k, v or out likewise; dout, autograd's tensor
rather than the model's, is copied contiguous where TMA cannot read it.

Under autograd (grad enabled and q, k or v requiring a gradient) the call
goes through :class:`FlashAttention`, the port of the JAX package's
``_flash`` custom VJP: its forward also writes each row's log-sum-exp and
saves ``q, k, v, out, lse``; its backward is the backward kernel
(``csrc/flash_attention_bwd.cu``) on the card and ``attention_bwd_ref`` on
the CPU.  Each launch is a ``torch.library`` custom op
(``repro_torch::flash_fwd``, ``flash_fwd_lse``, ``flash_bwd``) with a fake
implementation that allocates what the kernel allocates, a FLOP formula
(``torch.utils.flop_counter``) for what it issues and a byte formula
(``BYTES``, read by ``repro_torch.launch.hlo_cost``), so that a traced run
on fake tensors (the dry run) passes through it.  Without autograd the call is the serve path's launch, which
writes no lse.  ``q_offset`` places query row ``i`` at position
``q_offset + i`` in the forward and the backward alike (a context-parallel
shard of the queries against the whole keys, ``models.attention``); it
takes no gradient.  ``LAUNCHES`` counts launches by type and kind (a
backward call, three CUDA kernels, counts once), so a run can show that
its path went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import cost
from repro_torch.kernels.bitlinear.ops import resolve_backend
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref, attention_fwd_ref, attention_ref,
)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# forward launches (serve: no lse), forward launches that wrote the lse
# (training), backward calls; each by operand type
LAUNCHES: Dict[str, int] = {
    f"{kind}{name}": 0 for kind in ("", "lse_", "backward_")
    for name in ("float32", "bfloat16")}
MAX_HEAD_DIM = 128


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def tma_layout_error(shape, strides, data_ptr: int,
                     elem_size: int = 2) -> Optional[str]:
    """Why the bf16 kernel's TMA loads cannot read a ``[B, H, S, d]``
    operand of this layout, or None if they can: the base must be 16-byte
    aligned, and the byte strides of batch, head and position (axes of
    extent 1 excepted: the kernel never steps along them) and d's row
    length multiples of 16, so d % 8 == 0 in bf16."""
    if data_ptr % 16:
        return f"base address {data_ptr:#x} is not 16-byte aligned"
    if shape[-1] * elem_size % 16:
        return (f"d={shape[-1]}: rows of {shape[-1] * elem_size} bytes are "
                "not a multiple of 16")
    for axis, name in enumerate(("batch", "head", "position")):
        if shape[axis] > 1 and strides[axis] * elem_size % 16:
            return (f"{name} stride of {strides[axis] * elem_size} bytes is "
                    "not a multiple of 16")
    return None


def _type_name(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[1]


def _check_operands(tensors, d: int) -> None:
    """One kernel type over every operand, one device, unit stride along
    d, d <= MAX_HEAD_DIM."""
    dtype, device = tensors[0][1].dtype, tensors[0][1].device
    if dtype not in DTYPES or any(t.dtype != dtype for _, t in tensors):
        raise TypeError("the flash kernels take float32 or bfloat16 "
                        "operands of one type; got "
                        + ", ".join(f"{n} {t.dtype}" for n, t in tensors))
    if any(t.device != device for _, t in tensors):
        raise ValueError("the flash kernels' operands must lie on one CUDA "
                         "device")
    for label, t in tensors:
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{label} needs unit stride along its last axis")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the flash kernels take d <= {MAX_HEAD_DIM}; "
                         f"got {d}")


def _check_tma(tensors, who: str) -> None:
    """Raise unless TMA can read every bf16 operand named."""
    for label, t in tensors:
        why = tma_layout_error(t.shape, t.stride(), t.data_ptr())
        if why is not None:
            raise ValueError(f"the bf16 flash {who} takes {label} only "
                             f"in a layout TMA can read: {why}")


def _strided(tensors):
    args = []
    for t in tensors:
        args += [t.data_ptr(), t.stride(0), t.stride(1), t.stride(2)]
    return args


def _check_offset(q_offset) -> int:
    if isinstance(q_offset, bool) or not isinstance(q_offset, int) \
            or q_offset < 0:
        raise ValueError(f"q_offset must be an int >= 0; got {q_offset!r}")
    return q_offset


def _launch(q, k, v, causal: bool, sm_scale: float, with_lse: bool = False,
            q_offset: int = 0):
    """The forward kernel; returns o, or (o, lse float32 [B, H, Sq]) with
    ``with_lse``."""
    from repro_torch.kernels.build import library

    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    _check_operands((("q", q), ("k", k), ("v", v)), d)
    if q.dtype == torch.bfloat16:
        _check_tma((("q", q), ("k", k), ("v", v)), "kernel")
    # o in [B, S, H, d] memory order: the attention layer reads it that way
    o = _fwd_out(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if o.numel() == 0:
        return (o, lse) if with_lse else o
    fn = library("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = ([ci] + [vp, ll, ll, ll] * 4
                       + [ci] * 6 + [ctypes.c_float, ci, vp, vp, ci])
        fn.restype = ci
    rc = fn(DTYPES[q.dtype], *_strided((q, k, v, o)), b, h, hkv, sq, sk, d,
            sm_scale, int(causal), lse.data_ptr() if with_lse else None,
            torch.cuda.current_stream(q.device).cuda_stream,
            _check_offset(q_offset))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc} (B={b} H={h} Hkv={hkv} Sq={sq} "
                           f"Sk={sk} d={d} q_offset={q_offset} {q.dtype})")
    LAUNCHES[("lse_" if with_lse else "") + _type_name(q)] += 1
    return (o, lse) if with_lse else o


def _launch_bwd(q, k, v, o, lse, do, causal: bool, sm_scale: float,
                q_offset: int = 0, rowdot: Optional[torch.Tensor] = None):
    """The backward kernels; returns (dq, dk, dv) in the operands' type and
    layout.  ``rowdot`` is the float32 ``[B, H, Sq]`` scratch of the rows'
    dot D (allocated here if None)."""
    from repro_torch.kernels.build import library

    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if ((do.shape[-1] > 1 and do.stride(-1) != 1)
            or (do.dtype == torch.bfloat16 and tma_layout_error(
                do.shape, do.stride(), do.data_ptr()) is not None)):
        # dout is autograd's tensor, not the model's: an explicit copy
        do = do.contiguous()
    _check_operands((("q", q), ("k", k), ("v", v), ("out", o),
                     ("dout", do)), d)
    if q.dtype == torch.bfloat16:
        _check_tma((("q", q), ("k", k), ("v", v), ("out", o)),
                   "backward")
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous float32 [B, H, Sq] tensor")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    if rowdot is None:
        rowdot = _rowdot(q)
    fn = library("flash_attention_bwd").flash_attention_bwd_launch
    if fn.argtypes is None:
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = ([ci] + [vp, ll, ll, ll] * 8 + [vp, vp] + [ci] * 6
                       + [ctypes.c_float, ci, vp, ci])
        fn.restype = ci
    rc = fn(DTYPES[q.dtype], *_strided((q, k, v, o, do, dq, dk, dv)),
            lse.data_ptr(), rowdot.data_ptr(), b, h, hkv, sq, sk, d,
            sm_scale, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream,
            _check_offset(q_offset))
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {rc} (B={b} H={h} Hkv={hkv} Sq={sq} "
                           f"Sk={sk} d={d} q_offset={q_offset} {q.dtype})")
    LAUNCHES["backward_" + _type_name(q)] += 1
    return dq, dk, dv


def _rowdot(q: torch.Tensor) -> torch.Tensor:
    b, h, sq, _ = q.shape
    return torch.empty((b, h, sq), dtype=torch.float32, device=q.device)


def _fwd_out(q: torch.Tensor) -> torch.Tensor:
    """o in [B, S, H, d] memory order, as the forward kernel writes it."""
    b, h, sq, d = q.shape
    return torch.empty((b, sq, h, d), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


# --------------------------------------------------------------------------- #
# The launches as custom ops: fake implementations, FLOP and byte formulas
# --------------------------------------------------------------------------- #

@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=(),
                         device_types="cuda")
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, sm_scale: float,
                  q_offset: int) -> torch.Tensor:
    return _launch(q, k, v, causal, sm_scale, q_offset=q_offset)


@_flash_fwd_op.register_fake
def _(q, k, v, causal, sm_scale, q_offset):
    return _fwd_out(q)


@torch.library.custom_op("repro_torch::flash_fwd_lse", mutates_args=(),
                         device_types="cuda")
def _flash_fwd_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, sm_scale: float, q_offset: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _launch(q, k, v, causal, sm_scale, with_lse=True,
                   q_offset=q_offset)


@_flash_fwd_lse_op.register_fake
def _(q, k, v, causal, sm_scale, q_offset):
    b, h, sq, _ = q.shape
    return _fwd_out(q), q.new_empty((b, h, sq), dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_bwd", mutates_args=("rowdot",),
                         device_types="cuda")
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  rowdot: torch.Tensor, causal: bool, sm_scale: float,
                  q_offset: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _launch_bwd(q, k, v, o, lse, do, causal, sm_scale,
                       q_offset=q_offset, rowdot=rowdot)


@_flash_bwd_op.register_fake
def _(q, k, v, o, lse, do, rowdot, causal, sm_scale, q_offset):
    return tuple(torch.empty_like(t) for t in (q, k, v))


def _dims(q_shape, k_shape):
    b, h, sq, d = q_shape
    return b, h, k_shape[1], sq, k_shape[2], d


@register_flop_formula([torch.ops.repro_torch.flash_fwd,
                        torch.ops.repro_torch.flash_fwd_lse], get_raw=True)
def _flash_fwd_flops(q, k, v, causal, sm_scale, q_offset, *a, **kw):
    b, h, _hkv, sq, sk, d = _dims(q.shape, k.shape)
    return int(cost.flash_flops(b, h, sq, sk, d, causal, q.element_size(),
                                q_offset))


@register_flop_formula(torch.ops.repro_torch.flash_bwd, get_raw=True)
def _flash_bwd_flops(q, k, v, o, lse, do, rowdot, causal, sm_scale,
                     q_offset, *a, **kw):
    b, h, _hkv, sq, sk, d = _dims(q.shape, k.shape)
    return int(cost.flash_bwd_flops(b, h, sq, sk, d, causal,
                                    q.element_size(), q_offset))


def _fwd_bytes(q, k, v, causal, sm_scale, q_offset):
    return cost.flash_bytes(*_dims(q.shape, k.shape), causal,
                            q.element_size(), q_offset)


def _bwd_bytes(q, k, v, o, lse, do, rowdot, causal, sm_scale, q_offset):
    return cost.flash_bwd_bytes(*_dims(q.shape, k.shape), causal,
                                q.element_size(), q_offset)


# op overload packet -> bytes the launch moves, from its arguments
BYTES = {torch.ops.repro_torch.flash_fwd: _fwd_bytes,
         torch.ops.repro_torch.flash_fwd_lse: _fwd_bytes,
         torch.ops.repro_torch.flash_bwd: _bwd_bytes}


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, *t.shape[2:])


class FlashAttention(torch.autograd.Function):
    """Attention with the flash backward: the port of ``_flash``'s custom
    VJP (src/repro/models/attention.py).  The forward saves ``q, k, v,
    out, lse``; the backward recomputes the probabilities from the lse, so
    no ``[S, S]`` tensor is kept.  ``backend`` is resolved already:
    ``"cuda"`` launches the kernels, ``"reference"`` runs the plain
    versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, backend: str, q_offset: int = 0):
        b, h, sq, d = q.shape
        hkv = k.shape[1]
        if backend == "cuda":
            out, lse = torch.ops.repro_torch.flash_fwd_lse(
                q, k, v, causal, 1.0 / d ** 0.5, q_offset)
        else:
            out, lse = attention_fwd_ref(_flat(q), _flat(k), _flat(v),
                                         q_heads=h, kv_heads=hkv,
                                         causal=causal, q_offset=q_offset)
            out, lse = out.reshape(b, h, sq, d), lse.reshape(b, h, sq)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.backend, ctx.q_offset = causal, backend, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        b, h, sq, d = q.shape
        hkv, sk = k.shape[1], k.shape[2]
        if ctx.backend == "cuda":
            dq, dk, dv = torch.ops.repro_torch.flash_bwd(
                q, k, v, out, lse, dout, _rowdot(q), ctx.causal,
                1.0 / d ** 0.5, ctx.q_offset)
        else:
            dq, dk, dv = attention_bwd_ref(
                _flat(q), _flat(k), _flat(v), _flat(out),
                lse.reshape(b * h, sq), _flat(dout), q_heads=h,
                kv_heads=hkv, causal=ctx.causal, q_offset=ctx.q_offset)
            dq = dq.reshape(b, h, sq, d)
            dk, dv = dk.reshape(b, hkv, sk, d), dv.reshape(b, hkv, sk, d)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,       # [B, H,   Sq, d]
    k: torch.Tensor,       # [B, Hkv, Sk, d]
    v: torch.Tensor,       # [B, Hkv, Sk, d]
    *,
    causal: bool = True,
    backend: str = "auto",
    q_offset: int = 0,
) -> torch.Tensor:
    """Attention ``softmax(q k^T / sqrt(d)) v`` over ``[B, H, S, d]``
    tensors, query head ``h`` reading KV head ``h // (H / Hkv)``; output in
    q's type.  Causal masking is top-left (query position >= key
    position), query row ``i`` at position ``q_offset + i``.  Strided
    views (unit stride along ``d``) go in uncopied.
    The kernel fixes its own tiles and masks ragged edges, so no length has
    to divide them.  Differentiable: under autograd the call goes through
    :class:`FlashAttention`.
    """
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if (k.shape[0] != b or k.shape[-1] != d or tuple(v.shape) != tuple(
            k.shape) or hkv < 1 or h % hkv):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    backend = resolve_backend(backend, q)
    q_offset = _check_offset(q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, backend, q_offset)
    if backend == "cuda":
        return torch.ops.repro_torch.flash_fwd(q, k, v, causal,
                                               1.0 / d ** 0.5, q_offset)
    out = attention_ref(q.reshape(b * h, sq, d), k.reshape(b * hkv, sk, d),
                        v.reshape(b * hkv, sk, d), q_heads=h, kv_heads=hkv,
                        causal=causal, q_offset=q_offset)
    return out.reshape(b, h, sq, d)
