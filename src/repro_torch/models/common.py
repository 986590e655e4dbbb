"""Shared model building blocks (plain PyTorch functions over tensors)."""
from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from repro_torch.distributed.sharding import constrain, settle
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
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor) and x.ndim > 2:
        return matmul_sharded(x, w)
    return x @ w


def matmul_sharded(x, w):
    """``x [..., K] @ w [K, N]`` on DTensors, each rank multiplying its
    shards (``local_map``): DTensor's own matmul flattens x's leading axes
    first, which it refuses where a later one (the sequence, under
    context parallelism) is split.  Per mesh axis: x split along a row
    axis keeps it and gathers w there (FSDP); else w split by columns
    gives output columns; else a split K (either side's) is matched on the
    other and the products are partial sums."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    if not isinstance(w, DTensor):
        w = DTensor.from_local(w, mesh, [Replicate()] * mesh.ndim)
    x = settle(x)
    kx = x.ndim - 1
    xp, wp, outp, x_grad, w_grad = [], [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        if px.is_shard() and px.dim != kx:       # rows: batch, sequence
            xp.append(px), wp.append(Replicate()), outp.append(px)
            x_grad.append(px), w_grad.append(Partial())
        elif pw.is_shard(1):                     # column parallel
            xp.append(Replicate()), wp.append(pw), outp.append(Shard(kx))
            x_grad.append(Partial()), w_grad.append(pw)
        elif pw.is_shard(0) or px.is_shard(kx):  # row parallel: K split
            xp.append(Shard(kx)), wp.append(Shard(0)), outp.append(Partial())
            x_grad.append(Shard(kx)), w_grad.append(Shard(0))
        else:
            for lst in (xp, wp, outp, x_grad, w_grad):
                lst.append(Replicate())
    x, w = x.redistribute(mesh, xp), w.redistribute(mesh, wp)
    return local_map(
        torch.matmul, out_placements=(tuple(outp),),
        in_placements=(tuple(xp), tuple(wp)),
        in_grad_placements=(tuple(x_grad), tuple(w_grad)),
        device_mesh=mesh)(x, w)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * gamma.to(torch.float32)).to(dt)


def prompt_positions(x: torch.Tensor) -> torch.Tensor:
    """Positions ``[B, S]`` of a prompt's rows ``x [B, S, ...]``: 0 .. S-1
    on every row.  For a DTensor ``x``, a DTensor laid out as x's rows
    (each rank holds its rows' and sequence shard's positions), so that
    the RoPE tables are not built whole on every rank."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.distributed.sharding import local_extent

    b, s = x.shape[:2]
    if not isinstance(x, DTensor):
        return torch.arange(s, device=x.device)[None].expand(b, s)
    shape, start = local_extent(x)
    local = torch.arange(start[1], start[1] + shape[1],
                         device=x.to_local().device)[None].expand(
                             shape[0], shape[1])
    return DTensor.from_local(
        local, x.device_mesh,
        [pl if pl.is_shard() and pl.dim < 2 else Replicate()
         for pl in x.placements], shape=(b, s), stride=(s, 1))


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
    h = constrain(h, "batch", "seq", "ff")
    return dense(h, w2, quantize=quantize)


class _SumOverGroups(torch.autograd.Function):
    """A partial sum all-reduced over process groups, for a value every
    rank of those groups then uses alike; the gradient of each rank's part
    is the (replicated) gradient of the sum, as in Megatron's
    vocab-parallel cross-entropy."""

    @staticmethod
    def forward(ctx, x, groups):
        import torch.distributed._functional_collectives as funcol

        for grp in groups:
            x = funcol.all_reduce(x, "sum", grp)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _cross_entropy_sharded(logits, targets):
    """Per-token cross-entropy ``[B, S]`` of DTensor logits whose vocab
    may lie on mesh axes (vocab-parallel): each rank takes the row maxima,
    sums of exponentials and the gold logits of its vocab shard
    (``local_map``), and these are reduced over the vocab's axes; the
    result keeps the logits' row layout."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import local_extent

    mesh, vdim = logits.device_mesh, logits.ndim - 1
    if not isinstance(targets, DTensor):
        targets = DTensor.from_local(targets, mesh,
                                     [Replicate()] * mesh.ndim)
    rows = tuple(Replicate() if pl.is_shard(vdim) else pl
                 for pl in logits.placements)
    targets = targets.redistribute(mesh, rows)
    groups = [mesh.get_group(i) for i, pl in enumerate(logits.placements)
              if pl.is_shard(vdim)]
    shape, start = local_extent(logits)
    v0, vn = start[-1], shape[-1]

    def local(lg, tg):
        lg = lg.to(torch.float32)
        m = lg.detach().amax(dim=-1, keepdim=True)
        for grp in groups:
            m = funcol.all_reduce(m, "max", grp)
        sumexp = _SumOverGroups.apply(torch.exp(lg - m).sum(dim=-1), groups)
        idx = tg.long() - v0
        inside = (idx >= 0) & (idx < vn)
        gold = torch.gather(lg, -1, idx.clamp(0, max(vn - 1, 0))[..., None])
        gold = _SumOverGroups.apply(torch.where(inside, gold[..., 0], 0.0),
                                    groups)
        return torch.log(sumexp) + m[..., 0] - gold

    return local_map(local, out_placements=(rows,),
                     in_placements=(tuple(logits.placements), rows),
                     device_mesh=mesh)(logits, targets)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy; logits [B, S, V] f32-cast, targets [B, S].

    DTensor logits take :func:`_cross_entropy_sharded` (vocab-parallel),
    which reads no whole row of the vocab anywhere."""
    from torch.distributed.tensor import DTensor

    if isinstance(logits, DTensor):
        return torch.mean(_cross_entropy_sharded(logits, targets))
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
