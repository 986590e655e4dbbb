"""Mamba-2 (SSD) — the port so far holds its workload-zoo view only; the
model and the SSD scan kernel wait for their slice (ROADMAP.md, Queue 1).
"""
from __future__ import annotations


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
