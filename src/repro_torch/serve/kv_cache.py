"""KV-cache utilities: size accounting + latency-aware capacity planning.

The cache layouts themselves live with their models (models.attention.KVCache,
models.mamba2.SSMCache, models.hybrid.HybridCache); this module provides the
capacity planning the serving engine and the dry-run memory analysis use.

Admission control is latency-aware: feed the measured per-token decode
cycles from ``repro_torch.serve.legion_backend.LegionServeBackend.summary()``
(``cycles_per_decode_token``) plus the accelerator clock into :func:`plan`
and the :class:`CacheBudget` carries the sustainable decode rate — the
scheduler can then refuse batches whose token demand outruns what the
measured serve path delivers, not just what fits in HBM.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CacheBudget:
    bytes_per_token: int     # across all layers
    total_bytes: int
    fits_hbm: bool
    # Latency-aware fields (None without measured cycles): the decode rate
    # the accelerator sustains per slot, and across the planned batch.
    tokens_per_sec: Optional[float] = None       # one decode stream
    batch_tokens_per_sec: Optional[float] = None  # batch slots decoding
    # The serial (non-pipelined) reference rate, when the measured cycles
    # were engine-view overlapped ones — what the same steps would cost
    # without batch-level pipelining.
    serial_tokens_per_sec: Optional[float] = None
    # Page-granular capacity (``plan(page_tokens=...)``; None = contiguous
    # planning): the pool geometry a repro_torch.serve.paged_kv.PageAllocator
    # should be built with, plus the worst-case last-page padding if every
    # slot ran to max_seq.  ``total_bytes``/``fits_hbm`` then price the
    # page-quantized footprint, so planner and allocator agree exactly.
    page_tokens: Optional[int] = None
    bytes_per_page: Optional[int] = None
    pages_per_request: Optional[int] = None   # ceil(max_seq / page_tokens)
    pages_total: Optional[int] = None         # batch * pages_per_request
    page_waste_bytes: Optional[int] = None    # padding across the batch

    def seconds_to_fill(self, max_seq: int) -> Optional[float]:
        """Time to decode one slot's window at the measured rate."""
        if not self.tokens_per_sec:
            return None
        return max_seq / self.tokens_per_sec

    @property
    def pipelining_speedup(self) -> Optional[float]:
        """Overlapped vs serial decode rate (>= 1; None without both)."""
        if not (self.tokens_per_sec and self.serial_tokens_per_sec):
            return None
        return self.tokens_per_sec / self.serial_tokens_per_sec


def kv_bytes_per_token(cfg, dtype_bytes: int = 2) -> int:
    """Dense/moe/vlm: 2 * kv_heads * head_dim * layers * dtype."""
    if cfg.family in ("ssm",):
        return 0   # O(1) state
    layers = cfg.layers
    if cfg.family == "hybrid":
        import math
        layers = math.ceil(cfg.layers / cfg.attn_every)  # shared-attn apps
    return 2 * cfg.kv_heads * cfg.head_dim_ * layers * dtype_bytes


def plan(cfg, *, batch: int, max_seq: int, hbm_bytes_per_chip: float,
         chips: int, dtype_bytes: int = 2,
         cycles_per_token: Optional[float] = None,
         freq_hz: Optional[float] = None,
         serial_cycles_per_token: Optional[float] = None,
         page_tokens: Optional[int] = None) -> CacheBudget:
    """Capacity (and optionally latency) budget for a serving deployment.

    ``cycles_per_token`` is a *measured* per-token decode cost (e.g.
    ``LegionServeBackend.summary()["overlapped_cycles_per_decode_token"]``,
    the engine-view pipelined cost) at clock ``freq_hz`` (e.g.
    ``AcceleratorConfig.freq_hz``); both together add the tokens/sec
    fields to the budget.  Passing one without the other is an error — a
    cycle count without a clock is not a rate.  ``serial_cycles_per_token``
    optionally records the non-pipelined reference cost alongside (must
    ride on ``cycles_per_token``), giving the budget its
    ``pipelining_speedup``.

    ``page_tokens`` switches to page-granular planning (paged KV serving,
    ``repro_torch.serve.paged_kv``): capacity is priced in whole
    ``page_tokens``-token pages per request — each request rounds up to
    ``ceil(max_seq / page_tokens)`` pages — and the budget carries the
    pool geometry (``pages_total`` x ``bytes_per_page``) to build the
    allocator from, plus the worst-case last-page padding
    (``page_waste_bytes``).
    """
    if (cycles_per_token is None) != (freq_hz is None):
        raise ValueError(
            "pass cycles_per_token and freq_hz together (a measured cycle "
            "count needs a clock to become a rate)"
        )
    if serial_cycles_per_token is not None and cycles_per_token is None:
        raise ValueError(
            "serial_cycles_per_token is the reference for a measured "
            "cycles_per_token; pass both"
        )
    if page_tokens is not None and page_tokens < 1:
        raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
    bpt = kv_bytes_per_token(cfg, dtype_bytes)
    bytes_per_page = None
    pages_per_request = None
    pages_total = None
    page_waste = None
    if page_tokens is not None:
        bytes_per_page = bpt * page_tokens
        pages_per_request = -(-max_seq // page_tokens)
        pages_total = batch * pages_per_request
        # worst case: every slot runs to max_seq, padding only its last page
        page_waste = (pages_per_request * page_tokens - max_seq) * bpt \
            * batch
        total = pages_total * bytes_per_page
    else:
        total = bpt * batch * max_seq
    if cfg.family in ("ssm", "hybrid"):
        di, n = cfg.d_inner, cfg.ssm_state
        total += (di * n // max(cfg.ssm_head_dim, 1) * cfg.ssm_head_dim
                  * 4 * batch * cfg.layers)
    tps = None
    batch_tps = None
    serial_tps = None
    if cycles_per_token is not None:
        if cycles_per_token <= 0 or freq_hz <= 0:
            raise ValueError(
                f"cycles_per_token={cycles_per_token} and freq_hz={freq_hz} "
                f"must be > 0"
            )
        tps = freq_hz / cycles_per_token
        batch_tps = tps * batch
        if serial_cycles_per_token is not None:
            if serial_cycles_per_token < cycles_per_token:
                raise ValueError(
                    f"serial_cycles_per_token={serial_cycles_per_token} < "
                    f"cycles_per_token={cycles_per_token}: the pipelined "
                    f"cost can never exceed the serial one"
                )
            serial_tps = freq_hz / serial_cycles_per_token
    return CacheBudget(
        bytes_per_token=bpt, total_bytes=total,
        fits_hbm=total <= hbm_bytes_per_chip * chips,
        tokens_per_sec=tps, batch_tokens_per_sec=batch_tps,
        serial_tokens_per_sec=serial_tps,
        page_tokens=page_tokens, bytes_per_page=bytes_per_page,
        pages_per_request=pages_per_request, pages_total=pages_total,
        page_waste_bytes=page_waste,
    )
