"""Public wrapper of the flash-attention CUDA kernel: ``[B, H, S, d]``
layout and backend selection.

``backend="auto"`` launches the kernel (``csrc/flash_attention.cu``) for
CUDA tensors and runs the plain version (``ref.py``) for CPU tensors;
``"cuda"`` and ``"reference"`` force one side and raise for a tensor on the
other device: nothing falls back.  ``LAUNCHES`` counts kernel launches by
type, so a run can show that its path went through the kernel.  bfloat16
runs the tensor-core kernel, which loads q, k and v by TMA; a bf16 call
whose layout TMA cannot read (``tma_layout_error``) raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels.bitlinear.ops import resolve_backend
from repro_torch.kernels.flash_attention.ref import attention_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LAUNCHES: Dict[str, int] = {"float32": 0, "bfloat16": 0}
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


def _launch(q, k, v, causal: bool, sm_scale: float) -> torch.Tensor:
    from repro_torch.kernels.build import library

    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("the flash kernel takes float32 or bfloat16 q, k, v "
                        f"of one type; got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one CUDA device")
    for label, t in (("q", q), ("k", k), ("v", v)):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{label} needs unit stride along its last axis")
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the flash kernel takes d <= {MAX_HEAD_DIM}; "
                         f"got {d}")
    if q.dtype == torch.bfloat16:
        for label, t in (("q", q), ("k", k), ("v", v)):
            why = tma_layout_error(t.shape, t.stride(), t.data_ptr())
            if why is not None:
                raise ValueError(f"the bf16 flash kernel loads {label} by "
                                 f"TMA, which cannot read it: {why}")
    # o in [B, S, H, d] memory order: the attention layer reads it that way
    o = torch.empty((b, sq, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    if o.numel() == 0:
        return o
    fn = library("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = ([ci] + [vp, ll, ll, ll] * 4
                       + [ci] * 6 + [ctypes.c_float, ci, vp])
        fn.restype = ci
    args = []
    for t in (q, k, v, o):
        args += [t.data_ptr(), t.stride(0), t.stride(1), t.stride(2)]
    rc = fn(DTYPES[q.dtype], *args, b, h, hkv, sq, sk, d, sm_scale,
            int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc} (B={b} H={h} Hkv={hkv} Sq={sq} "
                           f"Sk={sk} d={d} {q.dtype})")
    LAUNCHES[str(q.dtype).split(".")[1]] += 1
    return o


def flash_attention(
    q: torch.Tensor,       # [B, H,   Sq, d]
    k: torch.Tensor,       # [B, Hkv, Sk, d]
    v: torch.Tensor,       # [B, Hkv, Sk, d]
    *,
    causal: bool = True,
    backend: str = "auto",
) -> torch.Tensor:
    """Attention ``softmax(q k^T / sqrt(d)) v`` over ``[B, H, S, d]``
    tensors, query head ``h`` reading KV head ``h // (H / Hkv)``; output in
    q's type.  Causal masking is top-left (query position >= key
    position).  Strided views (unit stride along ``d``) go in uncopied.
    The kernel fixes its own tiles and masks ragged edges, so no length has
    to divide them.
    """
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if (k.shape[0] != b or k.shape[-1] != d or tuple(v.shape) != tuple(
            k.shape) or hkv < 1 or h % hkv):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if resolve_backend(backend, q) == "cuda":
        return _launch(q, k, v, causal, 1.0 / d ** 0.5)
    out = attention_ref(q.reshape(b * h, sq, d), k.reshape(b * hkv, sk, d),
                        v.reshape(b * hkv, sk, d), q_heads=h, kv_heads=hkv,
                        causal=causal)
    return out.reshape(b, h, sq, d)
