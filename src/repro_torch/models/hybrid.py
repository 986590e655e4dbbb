"""Zamba2-style hybrid: Mamba-2 backbone + one *shared* attention block
applied before every ``attn_every``-th SSM block (weight-tied across
applications, as in Zamba/Zamba2).

The port of ``repro.models.hybrid``.  The JAX package scans the stack as
full periods of [shared-attn + ``attn_every`` mamba blocks] plus a tail
period; here one Python loop over the layers applies the shared
block before layer ``i`` whenever ``i % attn_every == 0`` (application
``i // attn_every``), which is the same order.  The shared block's
attention takes the flash path over prompts longer than
``FLASH_THRESHOLD`` (``models.attention``), and every Mamba block's scan
runs the SSD kernel on the card (``models.mamba2``).  Caches are written in
place.

Simplifications vs. the released Zamba2 (as in the JAX package): no per-
application LoRA deltas on the shared block and no concatenation with the
initial embedding — the shared block consumes the running hidden state.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.distributed.sharding import constrain
from repro_torch.models import mamba2
from repro_torch.models.attention import KVCache, attention, init_attn_params
from repro_torch.models.common import (
    dense,
    dense_init,
    maybe_remat,
    prompt_positions,
    dtype_of,
    embed_init,
    rms_norm,
    swiglu,
)
from repro_torch.obs.spans import layer_span


class HybridCache(NamedTuple):
    conv: torch.Tensor    # [L, B, conv_dim, k-1]
    state: torch.Tensor   # [L, B, H, N, P]
    k: torch.Tensor       # [A, B, Hkv, S_max, hd]  — shared-attn KV
    v: torch.Tensor


def n_attn_apps(cfg) -> int:
    return math.ceil(cfg.layers / cfg.attn_every)


def init_params(cfg, gen: torch.Generator, device) -> Dict:
    """Random parameters from ``gen`` in the JAX package's tree layout (the
    values differ: another generator)."""
    dtype = dtype_of(cfg)
    return {
        "embed": {"tokens": embed_init(gen, cfg.vocab, cfg.d_model, dtype,
                                       device)},
        "blocks": mamba2.init_blocks(cfg, gen, device),
        "shared": {
            "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
            "attn": init_attn_params(gen, cfg, dtype, device),
            "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
            "mlp": {
                "w1": dense_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
                "w2": dense_init(gen, cfg.d_ff, cfg.d_model, dtype, device),
                "w3": dense_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
            },
        },
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }


def _shared_block(cfg, shared, x, positions, cache=None, cache_pos=None):
    h = rms_norm(x, shared["ln1"])
    attn_out, new_cache = attention(
        shared["attn"], cfg, h, positions=positions, cache=cache,
        cache_pos=cache_pos,
    )
    x = x + attn_out
    h = rms_norm(x, shared["ln2"])
    x = x + swiglu(h, shared["mlp"]["w1"], shared["mlp"]["w2"],
                   shared["mlp"]["w3"],
                   quantize=cfg.quantization == "bitnet")
    return x, new_cache


def _mamba_stack(cfg, x, blocks, app: int,
                 cache: Optional[mamba2.SSMCache] = None,
                 decode: bool = False):
    """The Mamba blocks that follow shared-attention application ``app``."""
    e = cfg.attn_every
    layers = range(app * e, min((app + 1) * e, cfg.layers))
    # the JAX training scan lays out each period's parameters
    # (constrain_layer_params on the period's stack); here each layer's,
    # which is the layout that stack constraint means
    return mamba2.run_blocks(cfg, blocks, x, layers, cache=cache,
                             decode=decode, train_constraints=cache is None)


def _forward_cached(cfg, params, x, positions,
                    cache: Optional[HybridCache] = None, cache_pos=None,
                    decode: bool = False):
    """Every shared-attention application and Mamba block in order; the
    JAX package's period/tail scan.  ``cache=None`` is the training
    forward."""
    shared = params["shared"]
    apps = n_attn_apps(cfg)
    if cache is None:
        def period(x, app):
            with layer_span():
                x, _ = _shared_block(cfg, shared, x, positions)
            return _mamba_stack(cfg, x, params["blocks"], app)

        # the JAX scan rematerializes every full period, not the tail one
        remat = maybe_remat(period, cfg) if torch.is_grad_enabled() \
            else period
        for app in range(apps):
            x = (remat if app < apps - 1 else period)(x, app)
        return x
    ssm = mamba2.SSMCache(cache.conv, cache.state)
    for app in range(apps):
        kv = KVCache(cache.k[app], cache.v[app])
        x, _ = _shared_block(cfg, shared, x, positions, cache=kv,
                             cache_pos=cache_pos)
        x = _mamba_stack(cfg, x, params["blocks"], app, cache=ssm,
                         decode=decode)
    return x


def forward_train(cfg, params, batch) -> torch.Tensor:
    x = mamba2.embed_tokens(params, batch["tokens"])
    x = _forward_cached(cfg, params, x, prompt_positions(x))
    x = rms_norm(x, params["ln_f"])
    logits = dense(x, params["embed"]["tokens"].T)
    return constrain(logits, "batch", None, "vocab")


def init_cache(cfg, batch: int, max_seq: int, device) -> HybridCache:
    ssm = mamba2.init_cache(cfg, batch, max_seq, device)
    kv_shape = (n_attn_apps(cfg), batch, cfg.kv_heads, max_seq,
                cfg.head_dim_)
    dtype = dtype_of(cfg)
    return HybridCache(
        conv=ssm.conv, state=ssm.state,
        k=torch.zeros(kv_shape, dtype=dtype, device=device),
        v=torch.zeros(kv_shape, dtype=dtype, device=device),
    )


def forward_prefill(cfg, params, batch, cache: HybridCache):
    x = mamba2.embed_tokens(params, batch["tokens"])
    x = _forward_cached(cfg, params, x, prompt_positions(x), cache=cache)
    x = rms_norm(x, params["ln_f"])
    logits = dense(x[:, -1:, :], params["embed"]["tokens"].T)
    return logits, cache


def forward_decode(cfg, params, token, cache: HybridCache, pos):
    """One decode step. token [B] int, pos an int or per-slot [B] int
    tensor.  Returns (logits [B, 1, V], cache)."""
    x = mamba2.embed_tokens(params, token)[:, None, :]
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        positions = pos[:, None].to(torch.int32)
    else:
        positions = torch.full((x.shape[0], 1), int(pos), dtype=torch.int32,
                               device=x.device)
    x = _forward_cached(cfg, params, x, positions, cache=cache,
                        cache_pos=pos, decode=True)
    x = rms_norm(x, params["ln_f"])
    return dense(x, params["embed"]["tokens"].T), cache


def hybrid_lowering_spec(cfg, *, seq_len: int = 64, chunks: int = 2,
                         seed: int = 0):
    """The config's hybrid period as a
    :class:`repro_torch.legion.lowering.HybridSpec`: the shared attention
    block (applied ``n_attn_apps(cfg)`` times across the stack,
    weight-tied) sequenced before the ``cfg.layers`` Mamba blocks' SSD
    scans."""
    from repro_torch.legion.lowering import AttentionLoweringSpec, HybridSpec
    from repro_torch.models.mamba2 import ssd_lowering_spec

    attn = AttentionLoweringSpec(
        heads=cfg.n_heads, kv_heads=cfg.kv_heads, head_dim=cfg.head_dim_,
        hidden=cfg.d_model, seq_len=seq_len, weight_bits=cfg.weight_bits,
        layers=n_attn_apps(cfg), seed=seed, name=cfg.name,
    )
    return HybridSpec(attention=attn,
                      ssd=ssd_lowering_spec(cfg, chunks=chunks, seed=seed))
