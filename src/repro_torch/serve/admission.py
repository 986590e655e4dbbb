"""Live admission control — budget-gated request intake for the engine.

``ServeEngine`` historically admitted whenever a slot was free: the only
back-pressure was slot count.  At fleet scale that is how a serving tier
melts — every admitted request pins KV-cache rows for its whole lifetime
and adds decode tokens the accelerator must sustain, so admission has to
consult the *measured* capacity, not just slot arithmetic.

:class:`LiveAdmission` is the duck-typed policy ``ServeEngine`` consults
for every queue head (``decide(engine, request)``), returning one of

* ``"admit"``  — take the request now;
* ``"defer"``  — leave it queued: admitting it would push the pinned KV
  demand past the HBM budget, or the pending decode work past the latency
  horizon at the measured overlapped token rate.  Deferral is
  re-evaluated every step as slots drain;
* ``"refuse"`` — the request can *never* be served within budget (its own
  KV footprint alone exceeds capacity): pop it, flag
  ``Request.refused``, and move on.

The budget side comes from
:meth:`~repro_torch.serve.legion_backend.LegionServeBackend.cache_budget` — the
latency-aware :class:`~repro_torch.serve.kv_cache.CacheBudget` built from the
engine-view *overlapped* cycles per decode token — once the backend has
measured decode steps; before the first measurement only the capacity
checks apply (cold start must admit, or nothing is ever measured).  An
idle engine always admits an admissible request: deferral only makes
sense while active work can drain and free budget, so the policy can
never deadlock ``run_until_done``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.serve.kv_cache import kv_bytes_per_token

ADMIT = "admit"
DEFER = "defer"
REFUSE = "refuse"


@dataclasses.dataclass
class AdmissionStats:
    """Decision tally a :class:`LiveAdmission` keeps for introspection."""

    admitted: int = 0
    deferred_kv: int = 0        # KV-budget pressure deferrals
    deferred_rate: int = 0      # token-rate (latency-horizon) deferrals
    refused: int = 0
    # Evictions under KV-page pressure (incremented by the engine — the
    # policy admits, the paged engine preempts; see ServeEngine._preempt).
    preempted: int = 0

    @property
    def deferred(self) -> int:
        return self.deferred_kv + self.deferred_rate


class LiveAdmission:
    """KV- and rate-aware admission policy over a Legion serve backend.

    ``hbm_bytes_per_chip * chips`` bounds the KV bytes admitted requests
    may pin concurrently (each request pins ``prompt + max_new_tokens``
    rows, capped at the engine's ``max_seq`` window).
    ``max_pending_cycles`` (optional) adds the latency horizon: once the
    backend has measured decode steps, a request is deferred while the
    engine's outstanding decode tokens — including the candidate's —
    would take longer than the horizon at the measured overlapped
    cycles-per-token rate.
    """

    def __init__(self, backend, *, hbm_bytes_per_chip: float,
                 chips: int = 1, dtype_bytes: int = 2,
                 max_pending_cycles: Optional[float] = None) -> None:
        if hbm_bytes_per_chip <= 0 or chips < 1:
            raise ValueError(
                f"need hbm_bytes_per_chip > 0 and chips >= 1; got "
                f"{hbm_bytes_per_chip}, {chips}"
            )
        if max_pending_cycles is not None and max_pending_cycles <= 0:
            raise ValueError(
                f"max_pending_cycles must be > 0, got {max_pending_cycles}"
            )
        self.backend = backend
        self.hbm_bytes_per_chip = hbm_bytes_per_chip
        self.chips = chips
        self.dtype_bytes = dtype_bytes
        self.max_pending_cycles = max_pending_cycles
        self.stats = AdmissionStats()

    # ------------------------------------------------------------------ #
    def _kv_tokens(self, request, max_seq: int,
                   page_tokens: int = 0) -> int:
        """KV rows this request pins at its peak (window-capped); paged
        engines pin whole pages, so demand rounds up to a page boundary
        (the allocator and the policy must price capacity identically)."""
        tokens = min(len(request.prompt) + request.max_new_tokens, max_seq)
        if page_tokens:
            tokens = -(-tokens // page_tokens) * page_tokens
        return tokens

    def _budget(self, engine):
        """The measured CacheBudget, or None before any decode step."""
        if not self.backend.decode_steps:
            return None
        return self.backend.cache_budget(
            batch=engine.max_slots, max_seq=engine.max_seq,
            hbm_bytes_per_chip=self.hbm_bytes_per_chip, chips=self.chips,
            dtype_bytes=self.dtype_bytes,
        )

    def decide(self, engine, request) -> str:
        capacity = self.hbm_bytes_per_chip * self.chips
        budget = self._budget(engine)
        bpt = (budget.bytes_per_token if budget is not None
               else kv_bytes_per_token(self.backend.model_cfg,
                                       self.dtype_bytes))
        page_tokens = (engine.paged_kv.page_tokens
                       if getattr(engine, "paged_kv", None) is not None
                       else 0)
        demand = self._kv_tokens(request, engine.max_seq, page_tokens)
        if bpt and demand * bpt > capacity:
            # hard infeasibility: this request alone outruns the budget
            self.stats.refused += 1
            return REFUSE
        active = [s.request for s in engine.slots if s.request is not None]
        if not active:
            # idle engine: admit so something runs, measures, and drains
            self.stats.admitted += 1
            return ADMIT
        # KV pressure: rows pinned by the active set plus this request
        pinned = demand + sum(
            self._kv_tokens(r, engine.max_seq, page_tokens) for r in active)
        if bpt and pinned * bpt > capacity:
            self.stats.deferred_kv += 1
            return DEFER
        # token-rate pressure, once the overlapped rate is measured: the
        # outstanding decode tokens must drain within the latency horizon
        if (self.max_pending_cycles is not None and budget is not None
                and budget.tokens_per_sec):
            cycles_per_token = (self.backend.cfg.freq_hz
                                / budget.tokens_per_sec)
            pending = request.max_new_tokens + sum(
                max(r.max_new_tokens - len(r.output), 0) for r in active)
            if pending * cycles_per_token > self.max_pending_cycles:
                self.stats.deferred_rate += 1
                return DEFER
        self.stats.admitted += 1
        return ADMIT
