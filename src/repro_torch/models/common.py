"""Shared model building blocks (plain PyTorch functions over tensors)."""
from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from repro_torch.quant.bitnet import fake_quant_act, fake_quant_weight


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device) -> torch.Tensor:
    std = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=device)
    return (w * std).to(dtype)


def dense(
    x: torch.Tensor, w: torch.Tensor, *, quantize: bool = False,
) -> torch.Tensor:
    """Linear layer; ``quantize`` applies BitNet fake-quant.

    BitLinear = absmax-int8 activations x absmean-ternary weights.  The
    caller normalizes ``x`` first (BitNet wraps RMSNorm around quant).
    """
    if quantize:
        x = fake_quant_act(x)
        w = fake_quant_weight(w)
    if x.dtype != w.dtype:
        # JAX promotes (float32 frames @ a bf16 weight -> float32), where
        # torch.matmul refuses mixed types; the activations are never cast
        # down
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * gamma.to(torch.float32)).to(dt)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for RoPE. positions [...], returns [..., head_dim/2]."""
    half = head_dim // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(half, dtype=torch.float32, device=positions.device)
        / half
    )
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [..., S, H, D]; cos/sin [..., S, D/2] broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w1, w2, w3, *, quantize: bool):
    """SwiGLU MLP: (silu(x@w1) * (x@w3)) @ w2."""
    h = torch.nn.functional.silu(dense(x, w1, quantize=quantize)) * dense(
        x, w3, quantize=quantize
    )
    return dense(h, w2, quantize=quantize)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy; logits [B, S, V] f32-cast, targets [B, S]."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((vocab, d_model), generator=gen, device=device)
    return (w * 0.02).to(dtype)


def best_grouping(layers: int) -> int:
    """Divisor G of ``layers`` minimizing G + layers/G: the JAX package's
    two-level sqrt-remat grouping, a memory schedule of its scan over
    layers (G outer carries plus one group's inner ones).  The port's
    Python loop over layers keeps one carry a layer either way, so its
    remat (:func:`maybe_remat`) is one level and nothing in the port calls
    this: it is the JAX function's counterpart, held equal to it by a test,
    for a caller that plans the JAX schedule."""
    best = 1
    for g in range(1, layers + 1):
        if layers % g == 0 and (g + layers // g) < (best + layers // best):
            best = g
    return best


def maybe_remat(fn, cfg):
    """``fn`` recomputed in the backward instead of keeping its
    activations when ``cfg.remat`` is not ``"none"`` (the JAX package's
    ``jax.checkpoint`` of one block): ``torch.utils.checkpoint`` without
    reentrance, which keeps only the inputs.  The recomputation runs the
    same operations, so gradients do not change."""
    if cfg.remat == "none":
        return fn

    def wrapped(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)

    return wrapped
