"""Shared model building blocks (plain PyTorch functions over tensors)."""
from __future__ import annotations

import functools
import math

import torch
import torch.utils.checkpoint

from repro_torch.distributed.sharding import constrain, settle
from repro_torch.obs.spans import layer_span
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


class _TokenNLL(torch.autograd.Function):
    """Per-token cross-entropy of float32 logits ``lg [..., V]`` against
    targets ``tg [...]``: log sum exp(lg - m) + m - lg[tg], m the row
    maximum; with ``groups``, ``lg`` is this rank's vocab shard from
    ``v0`` and the maxima, sums and gold logits are all-reduced over those
    process groups (vocab-parallel, as Megatron's cross-entropy).  The
    backward is the closed form grad x (softmax - onehot(tg)) on this
    rank's shard, from the saved exponentials.  Written out rather than
    through ``torch.logsumexp`` and ``torch.gather``'s autograd, whose
    kernels and backward hold logits-sized temporaries that a traced run
    does not see or sees otherwise: under a dispatch mode (the dry run's
    counter, fake tensors) gather's backward scatters out of place, one
    more logits-sized tensor than on the card."""

    @staticmethod
    def forward(ctx, lg, tg, v0: int, groups):
        import torch.distributed._functional_collectives as funcol

        m = lg.amax(dim=-1, keepdim=True)
        for grp in groups:
            m = funcol.all_reduce(m, "max", grp)
        # exp in place on the temporary lg - m: two logits-sized tensors
        # live at once, and only the exponentials kept
        e = (lg - m).exp_()
        sumexp = e.sum(dim=-1)
        idx = tg.long() - v0
        vn = lg.shape[-1]
        inside = (idx >= 0) & (idx < vn)
        idx = idx.clamp(0, max(vn - 1, 0))[..., None]
        gold = torch.where(inside, torch.gather(lg, -1, idx)[..., 0], 0.0)
        for grp in groups:
            sumexp = funcol.all_reduce(sumexp, "sum", grp)
            gold = funcol.all_reduce(gold, "sum", grp)
        # an op on a collective's result waits for it: what is saved is a
        # plain tensor
        ctx.save_for_backward(e, sumexp.reciprocal(), idx, inside)
        return torch.log(sumexp) + m[..., 0] - gold

    @staticmethod
    def backward(ctx, grad):
        e, inv_sumexp, idx, inside = ctx.saved_tensors
        dlg = e * (grad * inv_sumexp)[..., None]
        dlg.scatter_add_(-1, idx, torch.where(inside, -grad, 0.0)[..., None])
        return dlg, None, None, None


def _token_nll(lg, tg, v0: int = 0, groups=()):
    """:class:`_TokenNLL` of ``lg`` cast to float32."""
    return _TokenNLL.apply(lg.to(torch.float32), tg, v0, tuple(groups))


def _cross_entropy_sharded(logits, targets):
    """Per-token cross-entropy ``[B, S]`` of DTensor logits whose vocab
    may lie on mesh axes (vocab-parallel): each rank takes the row maxima,
    sums of exponentials and the gold logits of its vocab shard
    (``local_map`` of :func:`_token_nll`), and these are reduced over the
    vocab's axes; the result keeps the logits' row layout."""
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
    v0 = local_extent(logits)[1][-1]
    return local_map(functools.partial(_token_nll, v0=v0, groups=groups),
                     out_placements=(rows,),
                     in_placements=(tuple(logits.placements), rows),
                     device_mesh=mesh)(logits, targets)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy; logits [B, S, V] f32-cast, targets [B, S]
    (:func:`_token_nll`, the same program on one device as on a mesh).

    DTensor logits take :func:`_cross_entropy_sharded` (vocab-parallel),
    which reads no whole row of the vocab anywhere."""
    from torch.distributed.tensor import DTensor

    if isinstance(logits, DTensor):
        return torch.mean(_cross_entropy_sharded(logits, targets))
    return torch.mean(_token_nll(logits, targets))


def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((vocab, d_model), generator=gen, device=device)
    return (w * 0.02).to(dtype)


def best_grouping(layers: int) -> int:
    """Divisor G of ``layers`` minimizing G + layers/G: the JAX package's
    two-level ("sqrt") remat grouping, which :func:`remat_layers` follows:
    G checkpointed groups of layers/G checkpointed layers keep G group
    inputs plus one group's layer inputs, not one input a layer."""
    best = 1
    for g in range(1, layers + 1):
        if layers % g == 0 and (g + layers // g) < (best + layers // best):
            best = g
    return best


def remat_groups(cfg, layers: int) -> int:
    """The groups of :func:`remat_layers`' schedule over ``layers`` layers
    (1: per-layer remat alone, or none)."""
    return best_grouping(layers) if cfg.remat != "none" else 1


# the products that ``remat="dots"`` keeps: jax.checkpoint_policies'
# checkpoint_dots_with_no_batch_dims, where a [B, S, D] @ [D, F] product
# runs as one 2-D mm of the flattened rows; batched products (bmm) and the
# kernels' custom ops are recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def maybe_remat(fn, cfg):
    """``fn`` recomputed in the backward instead of keeping its
    activations when ``cfg.remat`` is not ``"none"`` (the JAX package's
    ``jax.checkpoint``): ``torch.utils.checkpoint`` without reentrance,
    which keeps only the inputs (``"block"``), or, for ``"dots"``, also
    the outputs of the products without batch dims (:data:`_DOTS`,
    JAX's ``checkpoint_dots_with_no_batch_dims``).  The recomputation
    runs the same operations, so gradients do not change."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        from torch.utils.checkpoint import (
            create_selective_checkpoint_contexts,
        )

        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)

    def wrapped(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False, **kw)

    return wrapped


def remat_forwards(cfg, layers: int) -> int:
    """How many times a train step's forward and backward run the layers'
    forward under :func:`remat_layers`."""
    if cfg.remat == "none":
        return layers
    return (2 if remat_groups(cfg, layers) == 1 else 3) * layers


def remat_layers(layer, params, x, cfg):
    """``x`` through ``layer(p, x)`` for each ``p`` of ``params`` in order,
    rematerialized as the JAX package's train scan is: where
    :func:`remat_groups` gives G > 1, each group of len(params) / G
    consecutive layers runs under an outer :func:`maybe_remat` with each
    layer under its own inside (non-reentrant checkpoints nest), so the
    backward keeps G group inputs plus one group's layer inputs at a time;
    else each layer is rematerialized alone.  With G > 1 each layer's
    forward runs three times (the step's, its group's recomputation, its
    own), where per-layer remat alone runs it twice.  Each run of
    ``layer`` is a ``models.layer`` span, or ``models.layer_recompute``
    inside the backward (``repro_torch.obs.spans.layer_span``)."""
    def spanned(p, x):
        with layer_span():
            return layer(p, x)

    inner = maybe_remat(spanned, cfg)
    groups = remat_groups(cfg, len(params))
    if groups == 1:
        for p in params:
            x = inner(p, x)
        return x

    early_stop = torch.utils.checkpoint.set_checkpoint_early_stop

    def group(x, *group_params):
        # a layer's recomputation ends once it has what its backward
        # saved, as JAX's drops the products nothing reads (the last
        # projection's)
        with early_stop(True):
            for p in group_params:
                x = inner(p, x)
        return x

    outer = maybe_remat(group, cfg)
    size = len(params) // groups
    # a group's recomputation runs all of its layers, as JAX's scan does,
    # where torch's early stop would end it before the last, whose output
    # no layer saved
    with early_stop(False):
        for g in range(groups):
            x = outer(x, *params[g * size:(g + 1) * size])
    return x
