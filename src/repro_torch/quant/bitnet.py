"""BitNet b1.58 quantization — the model side of the paper's workloads.

Training uses fake-quant with straight-through estimators (QAT, the BitNet
recipe): ternary absmean weights and per-token absmax int8 activations,
whose forward value is dequant(quant(x)) and whose gradient is the
identity.  Serving materializes the real packed-ternary weights consumed
by the bitlinear CUDA kernel.  The fake-quant functions keep the JAX
package's expression ``x + stop_gradient(xq - x)`` (``.detach()`` here),
so that forward values agree bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.obs import spans
from repro_torch.quant import packing

EPS = 1e-5


class QuantizedTensor(NamedTuple):
    """Real (serving-side) quantized weight: packed payload + scale."""

    packed: torch.Tensor   # uint8 [..., K / (8/bits)], last-axis packed
    scale: torch.Tensor    # f32 scalar (absmean) — dequant = unpack * scale
    bits: int
    shape: tuple           # original unpacked shape

    def dequantize(self) -> torch.Tensor:
        vals = packing.unpack(self.packed, self.bits).to(torch.float32)
        return (vals * self.scale).reshape(self.shape)


# --------------------------------------------------------------------------- #
# Weight quantization: absmean ternary (BitNet b1.58)
# --------------------------------------------------------------------------- #

def weight_scale(w: torch.Tensor) -> torch.Tensor:
    """gamma = mean(|W|) (per tensor)."""
    return torch.mean(torch.abs(w)) + EPS


def quantize_weight_ternary(w: torch.Tensor):
    """W -> (Q in {-1,0,1} int8, gamma). dequant = Q * gamma."""
    gamma = weight_scale(w)
    q = torch.clamp(torch.round(w / gamma), -1, 1).to(torch.int8)
    return q, gamma


def pack_weight_ternary(w: torch.Tensor) -> QuantizedTensor:
    q, gamma = quantize_weight_ternary(w)
    return QuantizedTensor(
        packed=packing.pack_2bit(q.reshape(-1, q.shape[-1])),
        scale=gamma, bits=2, shape=tuple(w.shape),
    )


def fake_quant_weight(w: torch.Tensor) -> torch.Tensor:
    """Ternary fake-quant with STE: forward = dequant(quant(w)), grad = 1."""
    with spans.span(spans.FAKE_QUANT_WEIGHT):
        q, gamma = quantize_weight_ternary(w)
        wq = q.to(w.dtype) * gamma.to(w.dtype)
        return w + (wq - w).detach()


# --------------------------------------------------------------------------- #
# Activation quantization: per-token absmax int8 (BitNet)
# --------------------------------------------------------------------------- #

def act_scale(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.amax(torch.abs(x), dim=axis, keepdim=True) / 127.0 + EPS


def quantize_act_int8(x: torch.Tensor, axis: int = -1):
    s = act_scale(x, axis)
    q = torch.clamp(torch.round(x / s), -128, 127).to(torch.int8)
    return q, s


def fake_quant_act(x: torch.Tensor) -> torch.Tensor:
    """Per-token int8 fake-quant with STE."""
    with spans.span(spans.FAKE_QUANT_ACT):
        s = act_scale(x)
        xq = torch.clamp(torch.round(x / s), -128, 127) * s
        return x + (xq.to(x.dtype) - x).detach()


# --------------------------------------------------------------------------- #
# BitLinear: y = act_fq(x) @ weight_fq(W)    (QAT path)
#            y = int8(x) @ unpack(W_packed) * scales (serving path)
# --------------------------------------------------------------------------- #

def bit_linear_train(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """QAT forward: fake-quantized activations x fake-quantized weights.

    ``x`` is assumed pre-normalized (BitLinear wraps RMSNorm before quant,
    done by the caller).
    """
    return fake_quant_act(x) @ fake_quant_weight(w)


def bit_linear_serve(
    x: torch.Tensor, qw: QuantizedTensor, *, backend: str = "reference",
) -> torch.Tensor:
    """Serving forward with real ternary weights; ``x`` is ``[M, K]``.

    backend="reference": dequantize and multiply in ``x``'s dtype.
    backend="cuda":      int8 activations through the bitlinear kernel,
                         the weights repacked K-major on the way (the
                         kernel's layout; ``QuantizedTensor`` packs along
                         the last axis).
    """
    if backend == "cuda":
        from repro_torch.kernels.bitlinear import ops as bl_ops
        # the int8 cast below would cut the graph before the kernel's check
        bl_ops.refuse_grad("bitlinear", bl_ops.NO_BACKWARD, x)
        k, n = qw.shape
        w_kmajor = packing.pack_2bit_kmajor(
            packing.unpack(qw.packed, qw.bits).reshape(k, n))
        xq, xs = quantize_act_int8(x)
        out = bl_ops.bitlinear_matmul(xq, w_kmajor, bits=2, backend="cuda")
        return out.to(x.dtype) * (xs * qw.scale).to(x.dtype)
    if backend != "reference":
        raise ValueError(f"backend={backend!r}: expected 'reference' or "
                         "'cuda'")
    w = qw.dequantize().to(x.dtype)
    xq, xs = quantize_act_int8(x)
    return (xq.to(x.dtype) * xs.to(x.dtype)) @ w
