"""Decoder/encoder transformer over stacked ``[L, ...]`` layer parameters
(dense, MoE, VLM and encoder families).

The port of ``repro.models.transformer``: the JAX package's ``lax.scan``
over layers is a Python loop here.  Its sharding constraints are kept
(``repro_torch.distributed.sharding.constrain``): the identity on plain
tensors, a redistribution of DTensor activations and layer parameters
under the active rules (the dry run).  The two frontends are stubs, as
in JAX: an encoder
takes precomputed frame embeddings, a VLM precomputed patch embeddings
prepended to its text.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.distributed.sharding import (
    constrain, constrain_layer_params, settle,
)
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import (
    KVCache,
    attention,
    init_attn_params,
    init_kv_cache,
)
from repro_torch.models.common import (
    dense,
    dense_init,
    dtype_of,
    embed_init,
    prompt_positions,
    remat_layers,
    rms_norm,
    swiglu,
)


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #

def _init_block(cfg, gen, device) -> Dict:
    dtype = dtype_of(cfg)
    p = {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "attn": init_attn_params(gen, cfg, dtype, device),
    }
    if cfg.family == "moe":
        p["moe"] = moe_mod.init_moe_params(gen, cfg, dtype, device)
    else:
        p["mlp"] = {
            "w1": dense_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
            "w2": dense_init(gen, cfg.d_ff, cfg.d_model, dtype, device),
            "w3": dense_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
        }
    return p


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg, gen: torch.Generator, device) -> Dict:
    """Random parameters from ``gen`` (a ``torch.Generator`` on ``device``),
    in the JAX package's tree layout: per-layer leaves stacked ``[L, ...]``.
    The values differ from the JAX package's (another generator); tests
    share parameters through ``repro_torch.convert``.  An encoder keeps
    the token embedding it never reads, as the JAX package does."""
    dtype = dtype_of(cfg)
    params = {
        "embed": {"tokens": embed_init(gen, cfg.vocab, cfg.d_model, dtype,
                                       device)},
        "blocks": _stack([_init_block(cfg, gen, device)
                          for _ in range(cfg.layers)]),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab, dtype,
                                       device)
    if cfg.frontend == "audio_frames":
        # stub for the conv feature extractor: frames arrive pre-extracted
        params["frontend"] = {
            "proj": dense_init(gen, cfg.d_model, cfg.d_model, dtype, device)
        }
    return params


# --------------------------------------------------------------------------- #
# Blocks
# --------------------------------------------------------------------------- #

def _layers(blocks):
    """The stacked ``[L, ...]`` tree as ``L`` per-layer trees (views: one
    ``unbind``, so the gradient of a stacked leaf is assembled once)."""
    if isinstance(blocks, dict):
        per_key = {k: _layers(v) for k, v in blocks.items()}
        n = len(next(iter(per_key.values())))
        return [{k: per_key[k][i] for k in blocks} for i in range(n)]
    return blocks.unbind(0)


def _block(cfg, p, x, positions, cache=None, cache_pos=None):
    h = rms_norm(x, p["ln1"])
    attn_out, new_cache = attention(
        p["attn"], cfg, h, positions=positions, cache=cache,
        cache_pos=cache_pos,
    )
    x = x + attn_out
    h = rms_norm(x, p["ln2"])
    if cfg.family == "moe":
        x = x + moe_mod.moe_block(p["moe"], cfg, h)
    else:
        x = x + swiglu(h, p["mlp"]["w1"], p["mlp"]["w2"], p["mlp"]["w3"],
                       quantize=cfg.quantization == "bitnet")
    x = constrain(x, "batch", "seq", "embed")
    return x, new_cache


def _train_block(cfg, p, x, positions):
    p = constrain_layer_params(p, cfg)
    return _block(cfg, p, x, positions)[0]


def _run_blocks(cfg, blocks, x, positions, caches=None, cache_pos=None):
    """Every layer in order; ``caches`` (stacked ``[L, ...]``) are written
    in place, layer by layer.  Without caches and with grad enabled (the
    train path) the blocks are rematerialized as ``cfg.remat`` says, on
    the JAX scan's schedule (:func:`remat_layers`)."""
    layers = _layers(blocks)
    if caches is None and torch.is_grad_enabled():
        x = remat_layers(lambda p, x: _train_block(cfg, p, x, positions),
                         layers, x, cfg)
        return x, caches
    for i, p in enumerate(layers):
        if caches is None:
            p = constrain_layer_params(p, cfg)
        cache = None if caches is None else KVCache(caches.k[i], caches.v[i])
        x, _ = _block(cfg, p, x, positions, cache=cache, cache_pos=cache_pos)
    return x, caches


def _logits(cfg, params, x):
    x = rms_norm(x, params["ln_f"])
    if cfg.tie_embeddings:
        logits = dense(x, params["embed"]["tokens"].T)
    else:
        logits = dense(x, params["lm_head"])
    # seq deliberately unsharded here: vocab takes the model axis
    return constrain(logits, "batch", None, "vocab")


def _embed_inputs(cfg, params, batch):
    """The input rows x [B, S, d], a VLM's patches included (their
    positions: ``prompt_positions(x)``)."""
    if cfg.frontend == "audio_frames":
        # stub frontend: precomputed frame embeddings [B, S, d]
        x = dense(batch["frames"], params["frontend"]["proj"])
    else:
        # F.embedding's backward sums each row's gradient in a fixed order
        # (indexing's accumulates with atomics on the CPU), so a resumed
        # training run equals an uninterrupted one bit for bit
        x = settle(torch.nn.functional.embedding(batch["tokens"].long(),
                                                 params["embed"]["tokens"]))
        if cfg.frontend == "vision_patches":
            # stub ViT: precomputed patch embeddings prepended to the text
            x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    return x


# --------------------------------------------------------------------------- #
# Public forward functions
# --------------------------------------------------------------------------- #

def forward_train(cfg, params, batch) -> torch.Tensor:
    """The training-shaped forward (no cache): logits [B, S_total, V]."""
    x = constrain(_embed_inputs(cfg, params, batch), "batch", "seq", "embed")
    x, _ = _run_blocks(cfg, params["blocks"], x, prompt_positions(x))
    return _logits(cfg, params, x)


def init_cache(cfg, batch: int, max_seq: int, device) -> KVCache:
    single = init_kv_cache(cfg, batch, max_seq, dtype_of(cfg), device)
    return KVCache(single.k[None].repeat(cfg.layers, 1, 1, 1, 1),
                   single.v[None].repeat(cfg.layers, 1, 1, 1, 1))


def forward_prefill(cfg, params, batch, cache: KVCache):
    """Prompt pass: fills cache[:, :, :, :S), returns (last_logits, cache)."""
    x = _embed_inputs(cfg, params, batch)
    x, new_cache = _run_blocks(cfg, params["blocks"], x, prompt_positions(x),
                               caches=cache)
    logits = _logits(cfg, params, x[:, -1:, :])
    return logits, new_cache


def forward_prefill_chunk(cfg, params, tokens, cache: KVCache, pos0: int):
    """One fixed-budget slice of an in-flight prefill.

    tokens [B, C] int, ``pos0`` an int: writes rows ``[pos0, pos0 + C)`` of
    the cache in place (and no other row) and attends causally over
    everything at or below each chunk position — earlier chunks already
    live in the cache below ``pos0``.  Returns (last_logits [B, 1, V],
    cache); the logits are only meaningful on a prompt's final chunk.
    Tokens only, as in the JAX package: no frontend takes this path.
    """
    pos0 = int(pos0)
    x = settle(params["embed"]["tokens"][tokens])
    b, c = tokens.shape
    positions = (pos0 + torch.arange(c, dtype=torch.int32, device=x.device)
                 )[None].expand(b, c)
    x, new_cache = _run_blocks(cfg, params["blocks"], x, positions,
                               caches=cache, cache_pos=pos0)
    return _logits(cfg, params, x[:, -1:, :]), new_cache


def forward_decode(cfg, params, token, cache: KVCache, pos):
    """One decode step. token [B] int, pos an int or per-slot [B] int
    tensor.  Returns (logits [B, 1, V], new_cache)."""
    x = settle(params["embed"]["tokens"][token])[:, None, :]     # [B, 1, d]
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        positions = pos[:, None].to(torch.int32)
    else:
        positions = torch.full((x.shape[0], 1), int(pos), dtype=torch.int32,
                               device=x.device)
    x, new_cache = _run_blocks(cfg, params["blocks"], x, positions,
                               caches=cache, cache_pos=pos)
    return _logits(cfg, params, x), new_cache
