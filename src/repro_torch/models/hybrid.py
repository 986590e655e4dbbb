"""Zamba2-style hybrid (Mamba-2 backbone + one shared attention block
applied before every ``attn_every``-th SSM block) — the port so far holds
its workload-zoo view only; the model waits for its slice (ROADMAP.md,
Queue 1).
"""
from __future__ import annotations

import math


def n_attn_apps(cfg) -> int:
    return math.ceil(cfg.layers / cfg.attn_every)


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
