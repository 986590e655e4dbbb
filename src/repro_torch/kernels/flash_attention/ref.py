"""Plain PyTorch versions of the flash-attention kernels: full-softmax
attention with the GQA head mapping, in float32, output in q's type; the
forward with each row's log-sum-exp, and the backward.

The causal mask is the Pallas kernel's top-left one (query position >= key
position), which is also what the CUDA kernels compute.  The JAX package's
``attention_ref`` aligns it bottom-right (``tril(k=Sk-Sq)``) instead; the two
agree whenever ``Sq == Sk``, the only case any path of either package
reaches (ROADMAP.md, Queue 3).  ``q_offset`` places query row ``i`` at
position ``q_offset + i``, as the JAX package's ``_tile_scores`` does for a
context-parallel shard of the queries; it takes no gradient.

The backward follows ``_flash_bwd_impl`` (src/repro/models/attention.py),
the custom VJP the JAX model trains through, on whole ``[Sq, Sk]`` matrices
where it walks tiles: ``p = exp(s - lse)``, ``D = rowsum(dout * out)``,
``dv = p^T dout``, ``ds = p (dout v^T - D) scale``, ``dq = ds k``,
``dk = ds^T q``, the KV gradients summed over each group of query heads.
"""
from __future__ import annotations

from typing import Optional

import torch


def _expand(t: torch.Tensor, q_heads: int, kv_heads: int) -> torch.Tensor:
    """[B*Hkv, S, d] -> float32 [B*H, S, d], each KV head repeated for the
    query heads that read it."""
    bhkv, s, d = t.shape
    group = q_heads // kv_heads
    return t.reshape(bhkv // kv_heads, kv_heads, s, d).repeat_interleave(
        group, dim=1).reshape(-1, s, d).to(torch.float32)


def _scores(q, k, *, q_heads, kv_heads, causal, sm_scale, q_offset=0):
    """Scaled float32 scores [B*H, Sq, Sk], masked ones at -1e30."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     _expand(k, q_heads, kv_heads)) * sm_scale
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = torch.where((qpos >= kpos)[None], s,
                        torch.tensor(-1e30, device=q.device))
    return s


def attention_ref(
    q: torch.Tensor,       # [B*H,   Sq, d]
    k: torch.Tensor,       # [B*Hkv, Sk, d]
    v: torch.Tensor,       # [B*Hkv, Sk, d]
    *,
    q_heads: int,
    kv_heads: int,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    s = _scores(q, k, q_heads=q_heads, kv_heads=kv_heads, causal=causal,
                sm_scale=sm_scale, q_offset=q_offset)
    probs = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", probs, _expand(v, q_heads, kv_heads))
    return out.to(q.dtype)


def attention_fwd_ref(q, k, v, *, q_heads: int, kv_heads: int,
                      causal: bool = True,
                      sm_scale: Optional[float] = None, q_offset: int = 0):
    """:func:`attention_ref` and each row's log-sum-exp of the scaled
    scores (natural log, float32 ``[B*H, Sq]``): the residual the backward
    recomputes the probabilities from, as ``_flash_fwd`` saves it."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    s = _scores(q, k, q_heads=q_heads, kv_heads=kv_heads, causal=causal,
                sm_scale=sm_scale, q_offset=q_offset)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", torch.exp(s - lse[..., None]),
                       _expand(v, q_heads, kv_heads))
    return out.to(q.dtype), lse


def attention_bwd_ref(q, k, v, out, lse, dout, *, q_heads: int,
                      kv_heads: int, causal: bool = True,
                      sm_scale: Optional[float] = None, q_offset: int = 0):
    """(dq, dk, dv) of attention at ``q, k, v`` for the output gradient
    ``dout``, from the forward's ``out`` and ``lse`` (``[B*H, Sq]``), in the
    operands' types; the layouts of :func:`attention_ref`."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    f32 = torch.float32
    s = _scores(q, k, q_heads=q_heads, kv_heads=kv_heads, causal=causal,
                sm_scale=sm_scale, q_offset=q_offset)
    p = torch.exp(s - lse.to(f32)[..., None])
    do = dout.to(f32)
    rowdot = (do * out.to(f32)).sum(-1)                   # D [B*H, Sq]
    dv = torch.einsum("bqk,bqd->bkd", p, do)
    dp = torch.einsum("bqd,bkd->bqk", do, _expand(v, q_heads, kv_heads))
    ds = p * (dp - rowdot[..., None]) * sm_scale
    dq = torch.einsum("bqk,bkd->bqd", ds, _expand(k, q_heads, kv_heads))
    dk = torch.einsum("bqk,bqd->bkd", ds, q.to(f32))
    group = q_heads // kv_heads
    sk, d = k.shape[1:]

    def per_kv_head(t):                  # the GQA sum over each group
        return t.reshape(-1, kv_heads, group, sk, d).sum(2).reshape(-1, sk, d)

    return (dq.to(q.dtype), per_kv_head(dk).to(k.dtype),
            per_kv_head(dv).to(v.dtype))
