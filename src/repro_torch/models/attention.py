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

from repro_torch.distributed.sharding import (
    active_rules, constrain, local_extent,
)
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


def _takes_flash(q, k, kv_len) -> bool:
    """Long self-attention over whole prompts takes the flash path."""
    return (q.shape[1] > FLASH_THRESHOLD and q.shape[1] == k.shape[1]
            and kv_len is None and q.shape[1] % 1024 == 0
            and k.shape[1] % 512 == 0)


def _kv_heads_for(q_head0: int, heads: int, group: int, k_head0: int):
    """The local KV heads that ``heads`` local query heads read, the first
    at global head ``q_head0``, query head ``h`` reading KV head
    ``h // group``, from a shard whose first KV head is ``k_head0``: a
    slice (lo, hi) when every local KV head serves an equal run of local
    query heads (the kernel's own GQA mapping then holds), else the index
    of each query head's KV head."""
    need = [(q_head0 + i) // group - k_head0 for i in range(heads)]
    lo, hi = need[0], need[-1] + 1
    if heads % (hi - lo) == 0 and need == [
            lo + i // (heads // (hi - lo)) for i in range(heads)]:
        return (lo, hi)
    return need


def _sdpa_sharded(q, k, v, *, causal: bool, q_offset=None, kv_len=None):
    """:func:`_sdpa` on DTensors: each rank attends from its shard of the
    queries (batch rows, sequence positions, heads) to its shard of the
    keys and values (``local_map``), at the shards' global positions.
    Query heads sharded where the KV heads are replicated read the KV
    heads they map to.  Keys split along the sequence (long-context
    decode: the cache's sequence on a mesh axis) give each rank a partial
    softmax, combined over that axis by all-reduces of the row maxima,
    sums and outputs (flash-decoding).  A query shard of a long prompt
    runs the flash kernel with its position offset; under autograd the
    gradients of a replicated K / V add up over the ranks that share it
    (``Partial``)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    if isinstance(kv_len, torch.Tensor):
        raise ValueError("per-slot kv_len is not supported on DTensors")
    mesh = q.device_mesh
    k, v = (t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim) for t in (k, v))
    # along a mesh axis that splits the keys every rank needs the same
    # queries, so that their partial softmaxes combine
    q = q.redistribute(mesh, [
        Replicate() if kp.is_shard(1) and qp.is_shard() and qp.dim != 0
        else qp for qp, kp in zip(q.placements, k.placements)])
    _, q0 = local_extent(q)
    _, k0 = local_extent(k)
    group = q.shape[2] // k.shape[2]
    flash = _takes_flash(q, k, kv_len)
    split = [mesh.get_group(i) for i, pl in enumerate(k.placements)
             if pl.is_shard(1)]
    offset = (int(q_offset) if q_offset is not None else 0) + q0[1]

    def attend(ql, kl, vl):
        which = _kv_heads_for(q0[2], ql.shape[2], group, k0[2])
        if isinstance(which, tuple):
            kl, vl = kl[:, :, which[0]:which[1]], vl[:, :, which[0]:which[1]]
        else:
            idx = torch.tensor(which, device=kl.device)
            kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        if flash:
            out = flash_attention(ql.transpose(1, 2), kl.transpose(1, 2),
                                  vl.transpose(1, 2), causal=causal,
                                  q_offset=offset)
            return out.transpose(1, 2)
        b, s, h, hd = ql.shape
        t, hkv = kl.shape[1], kl.shape[2]
        qg = ql.reshape(b, s, hkv, h // hkv, hd)
        scores = torch.einsum("bskgd,btkd->bkgst", qg.to(torch.float32),
                              kl.to(torch.float32)) / (hd ** 0.5)
        kpos = k0[1] + torch.arange(t, device=ql.device)
        mask = None
        if causal:
            qpos = offset + torch.arange(s, device=ql.device)
            mask = qpos[:, None] >= kpos[None, :]
        elif kv_len is not None:
            mask = kpos < kv_len
        if mask is not None:
            scores = scores.masked_fill(~mask, -1e30)
        if not split:
            probs = torch.softmax(scores, dim=-1)
            out = torch.einsum("bkgst,btkd->bskgd", probs,
                               vl.to(torch.float32))
            return out.reshape(b, s, h, hd).to(ql.dtype)
        m = scores.amax(dim=-1, keepdim=True)
        for grp in split:
            m = funcol.all_reduce(m, "max", grp)
        e = torch.exp(scores - m)
        denom = e.sum(dim=-1)                                 # [b,k,g,s]
        out = torch.einsum("bkgst,btkd->bskgd", e, vl.to(torch.float32))
        for grp in split:
            denom = funcol.all_reduce(denom, "sum", grp)
            out = funcol.all_reduce(out, "sum", grp)
        out = out / denom.permute(0, 3, 1, 2)[..., None]
        return out.reshape(b, s, h, hd).to(ql.dtype)

    kv_grad = tuple(Partial() if kp == Replicate() and qp != Replicate()
                    else kp for qp, kp in zip(q.placements, k.placements))
    out_placements = tuple(Replicate() if k.placements[i].is_shard(1)
                           else pl for i, pl in enumerate(q.placements))
    return local_map(
        attend, out_placements=(out_placements,),
        in_placements=(q.placements, k.placements, v.placements),
        in_grad_placements=(q.placements, kv_grad, kv_grad),
        device_mesh=mesh)(q, k, v)


def _sdpa(q, k, v, *, causal: bool, q_offset=None, kv_len=None):
    """q [B,S,H,hd], k/v [B,T,Hkv,hd] — einsum attention, GQA via reshape.

    ``kv_len``: an int, or per-slot lengths ``[B]`` (continuous batching).
    DTensors take :func:`_sdpa_sharded`.
    """
    from torch.distributed.tensor import DTensor

    if isinstance(q, DTensor):
        return _sdpa_sharded(q, k, v, causal=causal, q_offset=q_offset,
                             kv_len=kv_len)
    if _takes_flash(q, k, kv_len):
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


def _write_rows(cache, rows, pos: int) -> None:
    """``cache[:, :, pos:pos + n] = rows`` in place (cache ``[B, Hkv, S,
    hd]``, rows ``[B, Hkv, n, hd]``).  A DTensor cache whose sequence lies
    on a mesh axis (long-context decode) is written shard by shard: each
    rank writes the rows that fall in its part of the sequence, from
    ``rows`` laid out as the cache but whole along the sequence."""
    from torch.distributed.tensor import DTensor, Replicate

    n = rows.shape[2]
    if not isinstance(cache, DTensor):
        cache[:, :, pos:pos + n] = rows
        return
    mesh = cache.device_mesh
    rows = rows.redistribute(mesh, [Replicate() if pl.is_shard(2) else pl
                                    for pl in cache.placements])
    shape, start = local_extent(cache)
    lo, hi = max(pos, start[2]), min(pos + n, start[2] + shape[2])
    if lo < hi:
        cache.to_local()[:, :, lo - start[2]:hi - start[2]] = \
            rows.to_local()[:, :, lo - pos:hi - pos]


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
    # under context parallelism "seq" carries the model axis and heads are
    # local; otherwise heads take the model axis (head-per-Legion mapping)
    q = constrain(q, "batch", "seq", "heads", None)
    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)

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
            _write_rows(kc, k.transpose(1, 2), pos)
            _write_rows(vc, v.transpose(1, 2), pos)
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
        _write_rows(cache.k, k.transpose(1, 2), 0)
        _write_rows(cache.v, v.transpose(1, 2), 0)
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
