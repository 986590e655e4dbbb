"""Multi-head attention with GQA/MQA, RoPE, qk-norm and KV caching.

The port of ``repro.models.attention``: the einsum path for sequences up to
``FLASH_THRESHOLD``, and for longer self-attention the flash path, where
the JAX package runs its chunked XLA twin of the flash kernel
(``_flash_ref``) and the port calls
:func:`repro_torch.kernels.flash_attention.ops.flash_attention`: the flash
kernel on the card, its plain version on the CPU.  Under sharding rules
that put the sequence on a mesh axis (``make_rules`` for the train and
prefill cells of the attention families), the flash path is
context-parallel (``_context_parallel_flash``): each rank along that axis
attends from its shard of the queries, at their global positions, to the
whole keys and values, and the shards' outputs are gathered.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import active_rules
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import (
    apply_rope, dense, dense_init, rms_norm, rope_angles,
)


class KVCache(NamedTuple):
    k: torch.Tensor   # [B, Hkv, S_max, hd]  ([L, B, ...] when stacked)
    v: torch.Tensor   # [B, Hkv, S_max, hd]


def init_attn_params(gen, cfg, dtype, device) -> dict:
    hd = cfg.head_dim_
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, dtype, device),
        "wk": dense_init(gen, cfg.d_model, cfg.kv_heads * hd, dtype, device),
        "wv": dense_init(gen, cfg.d_model, cfg.kv_heads * hd, dtype, device),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _project_qkv(p, cfg, x, positions):
    b, s, _ = x.shape
    hd = cfg.head_dim_
    quant = cfg.quantization == "bitnet"
    q = dense(x, p["wq"], quantize=quant).reshape(b, s, cfg.n_heads, hd)
    k = dense(x, p["wk"], quantize=quant).reshape(b, s, cfg.kv_heads, hd)
    v = dense(x, p["wv"], quantize=quant).reshape(b, s, cfg.kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q, k, v


class _GatherSeq(torch.autograd.Function):
    """The query shards' outputs all-gathered along the sequence (dim 1).
    Every rank goes on with the same replicated activations, so each holds
    the whole output gradient; the backward keeps this rank's rows, the
    gradient of its shard (an all-gather's own backward would add up the
    ranks' identical copies)."""

    @staticmethod
    def forward(ctx, local, group, ranks: int, rank: int):
        parts = [torch.empty_like(local) for _ in range(ranks)]
        dist.all_gather(parts, local.contiguous(), group=group)
        ctx.rows = (rank * local.shape[1], (rank + 1) * local.shape[1])
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.rows
        return grad[:, lo:hi], None, None, None


class _SumGrad(torch.autograd.Function):
    """The identity on an operand replicated over the group whose use
    differs by rank (a query shard, or K / V seen from one shard); the
    backward sums its gradient over the group, as the transpose of the
    JAX package's replicated ``shard_map`` in-spec does."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _context_parallel_flash(q, k, v, *, causal: bool, rules):
    """Context parallelism: the queries shard over the mesh axis that the
    rules give the sequence, K/V replicate (the paper's KV multicast).
    Each rank runs the flash kernel on its query slice with the position
    offset ``rank * s_local`` against the whole K and V, so the causal
    mask is the whole sequence's, and the shards' outputs are
    all-gathered.  q [B,S,H,hd]; k/v [B,S,Hkv,hd], the same on every rank
    of the axis."""
    seq_ax = rules.table["seq"]
    msize = rules.mesh.shape[seq_ax] if isinstance(seq_ax, str) else 1
    group, rank = rules.axis_group(seq_ax, q.device.type)
    s_local = q.shape[1] // msize
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        q, k, v = (_SumGrad.apply(t, group) for t in (q, k, v))
    qs = q[:, rank * s_local:(rank + 1) * s_local]
    out = flash_attention(qs.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal,
                          q_offset=rank * s_local)
    return _GatherSeq.apply(out.transpose(1, 2), group, msize, rank)


# Sequences at or below this length use the plain einsum path; longer
# self-attention takes the flash path.
FLASH_THRESHOLD = 2048


def _sdpa(q, k, v, *, causal: bool, q_offset=None, kv_len=None):
    """q [B,S,H,hd], k/v [B,T,Hkv,hd] — einsum attention, GQA via reshape.

    ``kv_len``: an int, or per-slot lengths ``[B]`` (continuous batching).
    """
    if (q.shape[1] > FLASH_THRESHOLD and q.shape[1] == k.shape[1]
            and kv_len is None and q.shape[1] % 1024 == 0
            and k.shape[1] % 512 == 0):
        rules = active_rules()
        if rules is not None and rules.table.get("seq") is not None:
            seq_ax = rules.table["seq"]
            msize = rules.mesh.shape.get(seq_ax, 1)
            if q.shape[1] % (msize * 128) == 0:
                return _context_parallel_flash(q, k, v, causal=causal,
                                               rules=rules)
        # [B,S,H,hd] -> [B,H,S,hd] views; the kernel reads them uncopied
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal)
        return out.transpose(1, 2)
    b, s, h, hd = q.shape
    t = k.shape[1]
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, s, hkv, g, hd)
    scores = torch.einsum(
        "bskgd,btkd->bkgst", qg.to(torch.float32), k.to(torch.float32)
    ) / (hd ** 0.5)
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None] + (
            q_offset if q_offset is not None else 0)
        kpos = torch.arange(t, device=q.device)[None, :]
        scores = torch.where((qpos >= kpos)[None, None, None], scores,
                             torch.tensor(-1e30, device=q.device))
    elif kv_len is not None:
        kpos = torch.arange(t, device=q.device)
        if isinstance(kv_len, torch.Tensor) and kv_len.ndim == 1:
            mask = kpos[None, :] < kv_len[:, None]          # [B, T]
            mask = mask[:, None, None, None, :]
        else:
            mask = (kpos < kv_len)[None, None, None, None, :]
        scores = torch.where(mask, scores,
                             torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(torch.float32))
    return out.reshape(b, s, h, hd).to(q.dtype)


def attention(
    p: dict, cfg, x: torch.Tensor, *, positions: torch.Tensor,
    cache: Optional[KVCache] = None, cache_pos=None,
) -> tuple:
    """Full attention sub-layer.

    Training/prefill: ``cache=None`` (or a cache to fill at [0, S)).
    Decode: x is [B, 1, d]; ``cache_pos`` an int write index or per-slot
    ``[B]`` int tensor.  Returns (out [B, S, d], new_cache).

    Unlike the JAX package, the cache is written in place (the returned
    cache holds the same tensors): the engine keeps one cache allocation.
    """
    b, s, _ = x.shape
    quant = cfg.quantization == "bitnet"
    q, k, v = _project_qkv(p, cfg, x, positions)

    new_cache = None
    if cache is not None and cache_pos is not None:
        # decode: append this step's K/V, attend over the full cache
        kc, vc = cache.k, cache.v
        if isinstance(cache_pos, torch.Tensor) and cache_pos.ndim == 1:
            rows = torch.arange(b, device=x.device)
            kc[rows, :, cache_pos] = k[:, 0]
            vc[rows, :, cache_pos] = v[:, 0]
            kv_len = cache_pos + 1
        else:
            pos = int(cache_pos)
            kc[:, :, pos:pos + s] = k.transpose(1, 2)
            vc[:, :, pos:pos + s] = v.transpose(1, 2)
            kv_len = pos + 1
        new_cache = KVCache(kc, vc)
        kt = kc.transpose(1, 2)     # [B, S_max, Hkv, hd]
        vt = vc.transpose(1, 2)
        if s > 1 and not isinstance(cache_pos, torch.Tensor):
            # prefill chunk staged at [cache_pos, cache_pos + s): causal
            # masking against global positions
            out = _sdpa(q, kt, vt, causal=True, q_offset=int(cache_pos))
        else:
            out = _sdpa(q, kt, vt, causal=False, kv_len=kv_len)
    elif cache is not None:
        # prefill: fill cache [0, S), causal attention over the prompt
        cache.k[:, :, :s] = k.transpose(1, 2)
        cache.v[:, :, :s] = v.transpose(1, 2)
        new_cache = KVCache(cache.k, cache.v)
        out = _sdpa(q, k, v, causal=cfg.causal)
    else:
        out = _sdpa(q, k, v, causal=cfg.causal)

    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim_)
    return dense(out, p["wo"], quantize=quant), new_cache


def init_kv_cache(cfg, batch: int, max_seq: int, dtype, device) -> KVCache:
    shape = (batch, cfg.kv_heads, max_seq, cfg.head_dim_)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))
