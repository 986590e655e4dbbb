"""Plain PyTorch version of the flash-attention kernel: full-softmax
attention with the GQA head mapping, in float32, output in q's type.

The causal mask is the Pallas kernel's top-left one (query position >= key
position), which is also what the CUDA kernel computes.  The JAX package's
``attention_ref`` aligns it bottom-right (``tril(k=Sk-Sq)``) instead; the two
agree whenever ``Sq == Sk``, the only case any path of either package
reaches (ROADMAP.md, Queue 3).
"""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(
    q: torch.Tensor,       # [B*H,   Sq, d]
    k: torch.Tensor,       # [B*Hkv, Sk, d]
    v: torch.Tensor,       # [B*Hkv, Sk, d]
    *,
    q_heads: int,
    kv_heads: int,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    bh, sq, d = q.shape
    sk = k.shape[1]
    b = bh // q_heads
    group = q_heads // kv_heads
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    # expand kv to q heads (the kernel maps each query head to its KV head)
    k = k.reshape(b, kv_heads, sk, d).repeat_interleave(group, dim=1)
    v = v.reshape(b, kv_heads, sk, d).repeat_interleave(group, dim=1)
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.reshape(bh, sk, d).to(torch.float32)) * sm_scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = torch.where((qpos >= kpos)[None], s,
                        torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", probs,
                       v.reshape(bh, sk, d).to(torch.float32))
    return out.to(q.dtype)
