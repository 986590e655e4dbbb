"""Traffic tracing + analytic cross-validation — making simulate() falsifiable.

The cycle simulator (``repro_torch.core.simulator``) *derives* memory traffic from
closed-form tile counts.  The tracer here *measures* it: the runtime reports
every stationary-tile fetch, activation-stream pass, and psum access it
actually performs while executing a StagePlan, and the tracer deduplicates
fetches the way the paper's NoC does (SS IV-B):

* stationary (weight / KV) tiles are fetched from memory once per
  ``multicast_group`` — GQA heads sharing a KV matrix, mapped across
  Legions, trigger a single multicast fetch per tile;
* the streamed activation matrix uses one time-multiplexed broadcast port
  per round: Legions consuming the same stream (input multicast) share one
  fetch per (round, N-tile pass, K-window).  The broadcast only applies
  when the data really is shared (shared input, or N-slices of one
  instance) — head-per-unit workloads with distinct per-head inputs
  stream privately, where the analytic model's single-stream-port formula
  undercounts (none of the paper's attention stages hit that case, but
  cross-validating such a workload will flag it: falsifiability working
  as intended);
* psum traffic is never deduplicated — the first K-window of a tile is a
  write, every later window a read-modify-write, exactly the ``2*KT - 1``
  accesses of the analytic model.

:func:`cross_validate` then runs every workload of a model end-to-end
through the runtime and compares measured per-stage totals against
``simulate()`` — the first executable check of the simulator's formulas.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, Iterable, List

from repro_torch.core.config import AcceleratorConfig
from repro_torch.core.workloads import GEMMWorkload


def relative_error(measured: float, analytic: float) -> float:
    """|measured - analytic| / analytic, with 0-vs-0 counting as exact.

    The single error metric of every runtime-vs-``simulate()``
    cross-validation (traffic here, cycles in ``repro_torch.legion.latency``).
    """
    if analytic == 0.0:
        return 0.0 if measured == 0.0 else float("inf")
    return abs(measured - analytic) / analytic


@dataclasses.dataclass
class TrafficTotals:
    weight_bytes: float = 0.0
    act_bytes: float = 0.0
    psum_bytes: float = 0.0
    # Paged-KV accounting (zero for contiguous runs): distinct page
    # fetches, whole-page bytes moved, and the last-page padding share.
    # The waste is ALSO folded into ``weight_bytes`` (a page fetch moves
    # padding the contiguous model never would), so weight_bytes minus a
    # contiguous run's equals page_waste_bytes exactly.
    page_fetches: float = 0.0
    page_bytes: float = 0.0
    page_waste_bytes: float = 0.0

    @property
    def mem_bytes(self) -> float:
        return self.weight_bytes + self.act_bytes

    def scaled(self, factor: float) -> "TrafficTotals":
        return TrafficTotals(
            weight_bytes=self.weight_bytes * factor,
            act_bytes=self.act_bytes * factor,
            psum_bytes=self.psum_bytes * factor,
            page_fetches=self.page_fetches * factor,
            page_bytes=self.page_bytes * factor,
            page_waste_bytes=self.page_waste_bytes * factor,
        )

    def add(self, other: "TrafficTotals") -> None:
        self.weight_bytes += other.weight_bytes
        self.act_bytes += other.act_bytes
        self.psum_bytes += other.psum_bytes
        self.page_fetches += other.page_fetches
        self.page_bytes += other.page_bytes
        self.page_waste_bytes += other.page_waste_bytes


class TrafficTracer:
    """Byte counter with NoC-style multicast deduplication.

    The runtime calls :meth:`weight_tile` / :meth:`act_stream` with a key
    identifying the physical transfer; repeats of the same key are free
    (the NoC multicasts one fetch to every consumer).  Keys are opaque —
    the runtime encodes its dedup policy in them.

    Implements the :class:`~repro_torch.legion.machine.Instrument` protocol, so a
    tracer registers directly on a ``Machine`` (``Machine.run`` attaches a
    fresh one per run by default).
    """

    def __init__(self) -> None:
        self.totals = TrafficTotals()
        self._seen_w: set = set()
        self._seen_a: set = set()
        self._seen_p: set = set()
        self.weight_fetches = 0       # distinct stationary-tile fetches
        self.act_passes = 0           # distinct stream passes
        self.page_fetches = 0         # distinct KV-page fetches (paged runs)
        self.multicast_hits = 0       # transfers saved by the NoC

    def weight_tile(self, key: Hashable, nbytes: float) -> None:
        if key in self._seen_w:
            self.multicast_hits += 1
            return
        self._seen_w.add(key)
        self.weight_fetches += 1
        self.totals.weight_bytes += nbytes

    def act_stream(self, key: Hashable, nbytes: float) -> None:
        if key in self._seen_a:
            self.multicast_hits += 1
            return
        self._seen_a.add(key)
        self.act_passes += 1
        self.totals.act_bytes += nbytes

    def page_fetch(self, key: Hashable, nbytes: float,
                   waste: float) -> None:
        """One whole-page KV fetch; only the last-page padding (``waste``)
        adds to ``weight_bytes`` — the page's useful tokens are already
        counted by the contiguous weight-fetch events, so the tracer's
        weight total exceeds a contiguous run's by exactly the accounted
        page-boundary waste."""
        if key in self._seen_p:
            self.multicast_hits += 1
            return
        self._seen_p.add(key)
        self.page_fetches += 1
        self.totals.page_fetches += 1
        self.totals.page_bytes += nbytes
        self.totals.page_waste_bytes += waste
        self.totals.weight_bytes += waste

    def psum(self, nbytes: float) -> None:
        self.totals.psum_bytes += nbytes

    # ---- Instrument protocol (repro_torch.legion.machine) ------------------- #
    def on_weight_fetch(self, key: Hashable, nbytes: float) -> None:
        self.weight_tile(key, nbytes)

    def on_act_stream(self, key: Hashable, nbytes: float) -> None:
        self.act_stream(key, nbytes)

    def on_page_fetch(self, key: Hashable, nbytes: float, waste: float,
                      *, stage: str, round_: int, legion: int) -> None:
        del stage, round_, legion
        self.page_fetch(key, nbytes, waste)

    def on_psum(self, nbytes: float) -> None:
        self.psum(nbytes)


# --------------------------------------------------------------------------- #
# Cross-validation against the analytic simulator
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class StageValidation:
    stage: str
    measured: TrafficTotals
    analytic: TrafficTotals
    rtol: float

    @property
    def errors(self) -> Dict[str, float]:
        return {
            "weight": relative_error(self.measured.weight_bytes,
                                     self.analytic.weight_bytes),
            "act": relative_error(self.measured.act_bytes,
                                  self.analytic.act_bytes),
            "psum": relative_error(self.measured.psum_bytes,
                                   self.analytic.psum_bytes),
            # 0-vs-0 counts as exact, so contiguous (un-paged) runs are
            # unaffected by the page channel.
            "page": relative_error(self.measured.page_bytes,
                                   self.analytic.page_bytes),
        }

    @property
    def ok(self) -> bool:
        return all(e <= self.rtol for e in self.errors.values())

    def __str__(self) -> str:
        errs = ", ".join(f"{k}={v * 100:.2f}%" for k, v in
                         self.errors.items())
        return (f"[{self.stage}] measured vs analytic: {errs} "
                f"({'OK' if self.ok else 'MISMATCH'} @ rtol={self.rtol})")


def cross_validate(
    cfg: AcceleratorConfig,
    workloads: Iterable[GEMMWorkload],
    *,
    rtol: float = 0.05,
    seed: int = 0,
    ztb_sparsity: float = 0.0,
    check_outputs: bool = True,
    device=None,
) -> List[StageValidation]:
    """Execute every workload through the legion runtime and compare the
    measured traffic against ``simulate()`` per stage.

    One layer of each workload executes numerically (synthetic int8 data);
    measured totals are scaled by ``w.layers`` to match the simulator's
    whole-model accounting.  With ``ztb_sparsity > 0`` the projection-stage
    weights are block-pruned, a ZeroTileBook is built per instance, and both
    sides account the skipped fully-sparse windows.

    Raises AssertionError if ``check_outputs`` and any executed output does
    not match the plain ``x @ w`` reference exactly (int32 accumulation).

    Thin wrapper over :meth:`repro_torch.legion.machine.Machine.cross_validate`
    (which measures traffic and cycles in a single execution pass).
    """
    from repro_torch.legion.machine import Machine

    traffic_vals, _cycle_vals = Machine(cfg, device=device).cross_validate(
        workloads, rtol=rtol, seed=seed, ztb_sparsity=ztb_sparsity,
        check_outputs=check_outputs,
    )
    return traffic_vals
