"""Mamba-2 (SSD) model — attention-free SSM family (mamba2-130m) and the
block reused by the Zamba2-style hybrid.

Block structure (faithful to Mamba-2):
    in_proj -> [z | xBC | dt];  xBC -> causal depthwise conv -> silu
    SSD scan over (x, B, C) with per-head decay a_t = exp(dt * A)
    gated RMSNorm (norm(y) * silu(z)) -> out_proj

The port of ``repro.models.mamba2``: the ``lax.scan`` over layers is a
Python loop; the sharding constraints are kept (the identity on plain
tensors, a redistribution of DTensors under the active rules).
The full-sequence scan is one call of :func:`repro_torch.kernels.ssd.ops.ssd`
on per-head inputs (the JAX package's Pallas branch): the SSD kernel for
CUDA tensors, its chunked plain version for CPU tensors, each with its
backward under autograd (the backward kernel on the card).  The
group-shared B and C go in as ``[B, S, N]``, read by the kernels with head
stride 0, uncopied; their gradients come back summed over the heads.
``cfg.kernel_backend``, a TPU choice between that branch and the grouped
jnp scan, is not read: both compute the same function.  A traced run of
the card's program (the dry run) takes the kernels' custom ops, forward
and backward.  Decode is the exact one-step recurrence in plain
tensor operations.  Prefill and decode
write the caches in place (the returned cache holds the same tensors).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (
    constrain, constrain_layer_params, settle,
)
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.common import (
    dense,
    dense_init,
    dtype_of,
    embed_init,
    remat_layers,
    rms_norm,
)
from repro_torch.models.transformer import _layers, _stack
from repro_torch.obs.spans import layer_span


class SSMCache(NamedTuple):
    conv: torch.Tensor   # [L, B, conv_dim, k-1] — depthwise conv history
    state: torch.Tensor  # [L, B, H, N, P]       — SSD recurrent state (f32)


def _dims(cfg) -> Tuple[int, int, int, int]:
    return cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim


def conv_dim(cfg) -> int:
    di, _, n, _ = _dims(cfg)
    return di + 2 * n     # x plus B and C streams go through the conv


def init_ssm_params(gen: torch.Generator, cfg, dtype, device) -> dict:
    di, nh, n, _ = _dims(cfg)
    cd = conv_dim(cfg)
    f32 = torch.float32
    return {
        "in_proj_z": dense_init(gen, cfg.d_model, di, dtype, device),
        "in_proj_xbc": dense_init(gen, cfg.d_model, cd, dtype, device),
        "in_proj_dt": dense_init(gen, cfg.d_model, nh, dtype, device),
        "out_proj": dense_init(gen, di, cfg.d_model, dtype, device),
        "conv_w": (torch.randn((cfg.conv_kernel, cd), generator=gen,
                               device=device) * 0.1).to(dtype),
        "conv_b": torch.zeros((cd,), dtype=dtype, device=device),
        "a_log": torch.zeros((nh,), dtype=f32, device=device),  # A = -exp
        "dt_bias": torch.full((nh,), -2.0, dtype=f32, device=device),
        "d_skip": torch.ones((nh,), dtype=f32, device=device),
        "norm": torch.ones((di,), dtype=dtype, device=device),
    }


def _causal_conv(xbc, w, b):
    """Depthwise causal conv over sequence. xbc [B,S,C], w [K,C].

    The JAX package's sum of shifted products (not ``F.conv1d``, which
    cuDNN would run in TF32 on float32 inputs).  On DTensors each rank
    convolves its rows and channels (the whole sequence)."""
    from torch.distributed.tensor import DTensor

    if isinstance(xbc, DTensor):
        return _causal_conv_sharded(xbc, w, b)
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    s = xbc.shape[1]
    out = pad[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, k):
        out = out + pad[:, i:i + s, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _causal_conv_sharded(xbc, w, b):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = xbc.device_mesh
    xp = tuple(Replicate() if pl.is_shard(1) or pl.is_partial() else pl
               for pl in xbc.placements)
    wp = tuple(Shard(1) if pl.is_shard(2) else Replicate() for pl in xp)
    bp = tuple(Shard(0) if pl.is_shard(2) else Replicate() for pl in xp)
    xbc = xbc.redistribute(mesh, xp)
    w, b = (t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim) for t in (w, b))
    w, b = w.redistribute(mesh, wp), b.redistribute(mesh, bp)
    # the channel weights' gradients add up over the batch rows' ranks
    grad = lambda ps: tuple(Partial() if px.is_shard(0) else p  # noqa: E731
                            for p, px in zip(ps, xp))
    return local_map(_causal_conv, out_placements=(xp,),
                     in_placements=(xp, wp, bp),
                     in_grad_placements=(xp, grad(wp), grad(bp)),
                     device_mesh=mesh)(xbc, w, b)


def ssm_block(
    p: dict, cfg, x: torch.Tensor, *,
    conv_state: Optional[torch.Tensor] = None,
    ssd_state: Optional[torch.Tensor] = None,
    decode: bool = False,
    return_state: bool = False,
):
    """x [B, S, d] -> (y [B, S, d], new_conv_state, new_ssd_state).

    Training/prefill: full-sequence path (conv over S, one SSD scan);
    ``return_state=True`` also yields the terminal SSD state (prefill).
    Decode (S == 1): single-step recurrence using the cached states.
    """
    b, s, _ = x.shape
    di, nh, n, hd = _dims(cfg)
    quant = cfg.quantization == "bitnet"
    f32 = torch.float32
    # inner activations shard over the model axis (depthwise conv and the
    # per-head SSD are channel/head-local, so this costs no collectives)
    z = constrain(dense(x, p["in_proj_z"], quantize=quant),
                  "batch", "seq", "d_inner")
    xbc = constrain(dense(x, p["in_proj_xbc"], quantize=quant),
                    "batch", "seq", "d_inner")
    dt = constrain(dense(x, p["in_proj_dt"], quantize=quant),
                   "batch", "seq", "ssm_heads")
    dt = F.softplus(dt.to(f32) + p["dt_bias"])                   # [B,S,nh]
    a = -torch.exp(p["a_log"])                                   # [nh]

    k = cfg.conv_kernel
    if decode:
        # roll the conv history and apply the kernel at one step
        hist = torch.cat([conv_state, xbc.transpose(1, 2)], dim=-1)
        new_conv_state = hist[..., 1:]
        xbc_t = torch.einsum("bck,kc->bc", hist, p["conv_w"]) + p["conv_b"]
        xbc_t = F.silu(xbc_t)[:, None, :]                        # [B,1,cd]
    else:
        xbc_t = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
        xbc_t = constrain(xbc_t, "batch", "seq", "d_inner")
        # cache the last k-1 conv inputs for subsequent decoding
        new_conv_state = (xbc.transpose(1, 2)[..., s - (k - 1):]
                          if s >= k - 1 else None)

    xs = xbc_t[..., :di]                     # [B,S,di]
    bmat = xbc_t[..., di:di + n]             # [B,S,N] (single group)
    cmat = xbc_t[..., di + n:]               # [B,S,N]
    xh = xs.reshape(b, s, nh, hd)
    xh = constrain(xh, "batch", "seq", "ssm_heads", None)

    if decode:
        # exact one-step recurrence: h = exp(dt a) h + dt B x^T; y = C h
        dta = dt[:, 0] * a[None, :]                        # [B,nh]
        dtx = xh[:, 0] * dt[:, 0][..., None]               # [B,nh,hd]
        h = torch.exp(dta)[..., None, None] * ssd_state + torch.einsum(
            "bn,bhp->bhnp", bmat[:, 0].to(f32), dtx.to(f32))
        y = torch.einsum("bn,bhnp->bhp", cmat[:, 0].to(f32), h)
        new_ssd_state = h
        y = y.reshape(b, 1, di)
    else:
        chunk = min(cfg.ssd_chunk, s)
        dta_h = (dt * a[None, None, :]).transpose(1, 2)          # [B,H,S]
        dtx_h = (xh * dt[..., None]).transpose(1, 2)             # [B,H,S,hd]
        y, new_ssd_state = _scan(dta_h, dtx_h, bmat.to(f32), cmat.to(f32),
                                 chunk, return_state)
        y = y.transpose(1, 2).reshape(b, s, di)

    y = y + (xh * p["d_skip"][None, None, :, None]).reshape(
        b, s, di).to(y.dtype)
    y = constrain(y, "batch", "seq", "d_inner")
    y = rms_norm(y.to(dtype_of(cfg)), p["norm"]) * F.silu(z)
    return (dense(y, p["out_proj"], quantize=quant), new_conv_state,
            new_ssd_state)


def _scan(dta_h, dtx_h, bmat, cmat, chunk: int, return_state: bool):
    """The SSD scan over the whole sequence: dta ``[B,H,S]``, dtx
    ``[B,H,S,P]``, the group-shared B and C ``[B,S,N]`` -> (y ``[B,H,S,P]``,
    terminal state or None), through :func:`ssd_ops.ssd`, which hands B
    and C to the kernels as they are (read with head stride 0, no copy).
    On DTensors the scan runs on each rank's batch rows and heads
    (``local_map``), which needs no collective; B and C, shared by the
    heads, are whole along the heads' mesh axes, and their gradients add up
    over those axes."""

    def heads(dta_h, dtx_h, bmat, cmat):
        out = ssd_ops.ssd(dta_h, dtx_h, bmat, cmat, chunk=chunk,
                          return_state=return_state)
        return out if return_state else (out, None)

    from torch.distributed.tensor import DTensor

    if not isinstance(dtx_h, DTensor):
        return heads(dta_h, dtx_h, bmat, cmat)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, pl = dtx_h.device_mesh, tuple(dtx_h.placements)
    # B and C [B, S, N] as dtx [B, H, S, P] but whole along the heads
    bc = tuple(Replicate() if p.is_shard(1) else Shard(1) if p.is_shard(2)
               else p for p in pl)
    bc_grad = tuple(Partial() if p.is_shard(1) else q
                    for p, q in zip(pl, bc))
    dta_pl = tuple(p if not p.is_shard(3) else Replicate() for p in pl)
    dta_h = dta_h.redistribute(mesh, dta_pl)
    bmat, cmat = (t.redistribute(mesh, bc) for t in (bmat, cmat))
    return local_map(
        heads, out_placements=(pl, pl if return_state else None),
        in_placements=(dta_pl, pl, bc, bc),
        in_grad_placements=(dta_pl, pl, bc_grad, bc_grad),
        device_mesh=mesh)(dta_h, dtx_h, bmat, cmat)


# --------------------------------------------------------------------------- #
# Full attention-free model (mamba2-130m)
# --------------------------------------------------------------------------- #

def init_blocks(cfg, gen: torch.Generator, device) -> Dict:
    """``cfg.layers`` Mamba blocks, per-layer leaves stacked ``[L, ...]``."""
    dtype = dtype_of(cfg)
    return _stack([{
        "ln": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "ssm": init_ssm_params(gen, cfg, dtype, device),
    } for _ in range(cfg.layers)])


def init_params(cfg, gen: torch.Generator, device) -> Dict:
    """Random parameters from ``gen`` in the JAX package's tree layout (the
    values differ: another generator; tests share parameters through
    ``repro_torch.convert``)."""
    dtype = dtype_of(cfg)
    return {
        "embed": {"tokens": embed_init(gen, cfg.vocab, cfg.d_model, dtype,
                                       device)},
        "blocks": init_blocks(cfg, gen, device),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }


def run_blocks(cfg, blocks, x, layers, cache: Optional[SSMCache] = None,
               decode: bool = False, train_constraints: bool = False,
               remat: bool = False):
    """Residual Mamba blocks ``layers`` (indices into the stacked
    ``blocks``) in order.  With ``cache`` (stacked ``[L, ...]``) prefill
    (``decode=False``) and decode write each layer's conv and SSD states
    in place.  ``train_constraints`` lays each layer's parameters out by
    the active rules first (``constrain_layer_params``), as the JAX
    training scan does.  ``remat``: without a cache and with grad enabled
    (the train path) the blocks are rematerialized as ``cfg.remat`` says,
    on the JAX model's scan schedule (:func:`remat_layers`; the hybrid's
    inner stack is not).  Each train layer runs in a ``models.layer`` span
    (``repro_torch.obs.spans.layer_span``)."""
    per_layer = _layers(blocks)

    def train_layer(lp, x):
        if train_constraints:
            lp = constrain_layer_params(lp, cfg)
        return x + ssm_block(lp["ssm"], cfg, rms_norm(x, lp["ln"]))[0]

    if cache is None:
        if remat and torch.is_grad_enabled():
            return remat_layers(train_layer, [per_layer[i] for i in layers],
                                x, cfg)
        for i in layers:
            with layer_span():
                x = train_layer(per_layer[i], x)
        return x
    for i in layers:
        lp = per_layer[i]
        h = rms_norm(x, lp["ln"])
        if decode:
            y, conv_st, ssd_st = ssm_block(
                lp["ssm"], cfg, h, conv_state=cache.conv[i],
                ssd_state=cache.state[i], decode=True)
            cache.conv[i] = conv_st
            cache.state[i] = ssd_st
        else:
            y, conv_st, ssd_st = ssm_block(lp["ssm"], cfg, h,
                                           return_state=True)
            if conv_st is not None:
                cache.conv[i] = conv_st
            cache.state[i] = ssd_st
        x = x + y
    return x


def embed_tokens(params, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings of ``tokens`` (any shape)."""
    # F.embedding's backward sums each row's gradient in a fixed order
    # (indexing's accumulates with atomics on the CPU), so a resumed
    # training run equals an uninterrupted one bit for bit
    return settle(F.embedding(tokens.long(), params["embed"]["tokens"]))


def forward_train(cfg, params, batch) -> torch.Tensor:
    x = embed_tokens(params, batch["tokens"])
    x = run_blocks(cfg, params["blocks"], x, range(cfg.layers),
                   train_constraints=True, remat=True)
    x = rms_norm(x, params["ln_f"])
    logits = dense(x, params["embed"]["tokens"].T)
    return constrain(logits, "batch", None, "vocab")


def init_cache(cfg, batch: int, max_seq: int, device) -> SSMCache:
    del max_seq  # O(1) state — the whole point of the SSM family
    _, nh, n, hd = _dims(cfg)
    return SSMCache(
        conv=torch.zeros((cfg.layers, batch, conv_dim(cfg),
                          cfg.conv_kernel - 1), dtype=dtype_of(cfg),
                         device=device),
        state=torch.zeros((cfg.layers, batch, nh, n, hd),
                          dtype=torch.float32, device=device),
    )


def forward_prefill(cfg, params, batch, cache: SSMCache):
    """Prefill is a full forward that also extracts terminal states."""
    x = embed_tokens(params, batch["tokens"])
    x = run_blocks(cfg, params["blocks"], x, range(cfg.layers), cache=cache)
    x = rms_norm(x, params["ln_f"])
    logits = dense(x[:, -1:, :], params["embed"]["tokens"].T)
    return logits, cache


def forward_decode(cfg, params, token, cache: SSMCache, pos):
    """One decode step; ``pos`` is unused (the state carries the past)."""
    del pos
    x = embed_tokens(params, token)[:, None, :]
    x = run_blocks(cfg, params["blocks"], x, range(cfg.layers), cache=cache,
                   decode=True)
    x = rms_norm(x, params["ln_f"])
    return dense(x, params["embed"]["tokens"].T), cache


def ssd_lowering_spec(cfg, *, chunks: int = 2, seed: int = 0):
    """The config's SSD scan segment as a
    :class:`repro_torch.legion.lowering.SSDSpec` — the D-Legion
    workload-zoo view of this model's chunked state/output GEMMs (the SSD
    scan's geometry: ``ssm_heads`` heads, ``ssd_chunk``-step chunks, state
    width ``ssm_state``, head dim ``ssm_head_dim``)."""
    from repro_torch.legion.lowering import SSDSpec

    return SSDSpec(
        heads=cfg.ssm_heads, chunk=cfg.ssd_chunk, state=cfg.ssm_state,
        head_dim=cfg.ssm_head_dim, chunks=chunks, layers=cfg.layers,
        seed=seed, name=cfg.name,
    )
