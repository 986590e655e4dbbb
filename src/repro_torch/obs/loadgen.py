"""Fleet-scale load harness — synthetic arrival traces through ServeEngine.

The ROADMAP's millions-of-users north star needs tail-latency numbers,
not just per-step means: what does p99 time-to-first-token look like when
a Poisson arrival stream (or a thundering-herd burst) hits a
continuous-batching engine with a handful of slots?  This module drives a
real :class:`~repro_torch.serve.engine.ServeEngine` (the model's prefill and
decode steps, actual slot scheduling) while advancing a **virtual cycle clock**
from the Legion cycle model: each prefill costs its measured standalone
step cycles, each batched decode costs the *overlapped* engine-view
cycles from :meth:`~repro_torch.serve.legion_backend.LegionServeBackend
.step_pipeline` — so hundreds of requests produce p50/p99 TTFT and
per-token latencies in model cycles (and microseconds at the
accelerator's clock), with occupancy-over-time and rejected/deferred
admission counts alongside.  In-flight engines
(``prefill_chunk_tokens=``) emit one merged ``step`` event per engine
step, priced by the merged mixed-phase Program's overlapped cycles
(:meth:`~repro_torch.serve.legion_backend.LegionServeBackend
.step_pipeline_mixed`); window-truncated completions and
admission-refused requests surface in :meth:`LoadReport.summary` as
``truncated`` / ``refused`` (with ``goodput`` excluding truncations).

The backend's compositional caches make this cheap: a 200-request trace
re-executes only previously unseen (rows, context) attention pairs; the
clock arithmetic is pure Python over cached tallies.

    trace = poisson_trace(200, mean_interarrival_cycles=50_000, seed=0)
    report = run_load(engine, backend, trace)
    report.summary(freq_hz=cfg.freq_hz)   # p50/p99 TTFT, per-token, ...
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

# Default mixed request shapes: a few distinct prompt lengths (bounding
# the set of prefill shapes) and short output budgets.
PROMPT_LENS = (4, 8, 12)
OUTPUT_LENS = (2, 3, 4, 6)


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One synthetic request arrival on the virtual cycle clock."""

    time: float                # arrival timestamp, model cycles
    prompt_len: int
    max_new_tokens: int


def poisson_trace(
    n: int, *, mean_interarrival_cycles: float,
    prompt_lens: Sequence[int] = PROMPT_LENS,
    output_lens: Sequence[int] = OUTPUT_LENS, seed: int = 0,
) -> List[Arrival]:
    """``n`` arrivals with exponential inter-arrival gaps (Poisson
    process) and prompt/output lengths drawn from the given sets."""
    if n <= 0:
        raise ValueError(f"need n > 0 arrivals; got {n}")
    rng = np.random.default_rng(seed)
    t = 0.0
    out: List[Arrival] = []
    for _ in range(n):
        t += float(rng.exponential(mean_interarrival_cycles))
        out.append(Arrival(
            time=t, prompt_len=int(rng.choice(prompt_lens)),
            max_new_tokens=int(rng.choice(output_lens)),
        ))
    return out


def lognormal_trace(
    n: int, *, mean_interarrival_cycles: float, sigma: float = 1.0,
    mean_prompt: float = 8.0, mean_output: float = 3.0,
    max_prompt: int = 16, max_output: int = 6, quantum: int = 4,
    seed: int = 0,
) -> List[Arrival]:
    """``n`` arrivals with heavy-tailed (lognormal) inter-arrival gaps
    *and* lognormal prompt/output lengths — the production-shaped load
    where a few long prompts pin disproportionate KV while short ones
    stream past (the mix that makes paged eviction earn its keep).

    Prompt lengths round **up** to a multiple of ``quantum`` and clamp to
    ``[quantum, max_prompt]``, so however heavy the tail, the engine only
    ever sees ``max_prompt / quantum`` distinct prefill shapes.
    ``sigma`` is the log-space spread; the gap distribution's *mean* is
    held at ``mean_interarrival_cycles`` regardless (mu is solved from
    it), so traces stay rate-comparable with :func:`poisson_trace`.
    """
    if n <= 0:
        raise ValueError(f"need n > 0 arrivals; got {n}")
    if mean_interarrival_cycles <= 0 or sigma <= 0:
        raise ValueError(
            f"need mean_interarrival_cycles > 0 and sigma > 0; got "
            f"{mean_interarrival_cycles}, {sigma}"
        )
    if quantum < 1 or max_prompt < quantum or max_output < 2:
        raise ValueError(
            f"need quantum >= 1, max_prompt >= quantum, max_output >= 2; "
            f"got {quantum}, {max_prompt}, {max_output}"
        )
    rng = np.random.default_rng(seed)
    mu_gap = float(np.log(mean_interarrival_cycles) - sigma ** 2 / 2.0)
    t = 0.0
    out: List[Arrival] = []
    for _ in range(n):
        t += float(rng.lognormal(mu_gap, sigma))
        p = int(rng.lognormal(np.log(mean_prompt), sigma))
        o = int(rng.lognormal(np.log(mean_output), sigma))
        p = min(-(-max(p, 1) // quantum) * quantum, max_prompt)
        out.append(Arrival(
            time=t, prompt_len=p,
            max_new_tokens=min(max(o, 2), max_output),
        ))
    return out


def bursty_trace(
    n: int, *, burst_size: int, burst_gap_cycles: float,
    prompt_lens: Sequence[int] = PROMPT_LENS,
    output_lens: Sequence[int] = OUTPUT_LENS, seed: int = 0,
) -> List[Arrival]:
    """``n`` arrivals in simultaneous bursts of ``burst_size``, one burst
    every ``burst_gap_cycles`` — the admission-spike shape that exercises
    queueing and deferral."""
    if n <= 0 or burst_size <= 0:
        raise ValueError(f"need n > 0 and burst_size > 0; got {n}, "
                         f"{burst_size}")
    rng = np.random.default_rng(seed)
    out: List[Arrival] = []
    for i in range(n):
        out.append(Arrival(
            time=(i // burst_size) * float(burst_gap_cycles),
            prompt_len=int(rng.choice(prompt_lens)),
            max_new_tokens=int(rng.choice(output_lens)),
        ))
    return out


@dataclasses.dataclass(frozen=True)
class SLO:
    """Latency service-level objective ``run_load(slo=...)`` grades
    completions against: with one set, :meth:`LoadReport.summary`'s
    ``goodput`` counts only completions inside the objective (truncated
    outputs already never count)."""

    ttft_cycles: Optional[float] = None       # time-to-first-token bound
    per_token_cycles: Optional[float] = None  # mean decode latency bound

    def __post_init__(self) -> None:
        for name in ("ttft_cycles", "per_token_cycles"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be > 0, got {v}")

    def met(self, rec: "RequestRecord") -> bool:
        """Did a *completed* record meet every bound set?  A record with
        no decode tokens (done at its prompt boundary) has no per-token
        latency to violate."""
        if rec.finish is None:
            return False
        if self.ttft_cycles is not None:
            if rec.ttft is None or rec.ttft > self.ttft_cycles:
                return False
        if self.per_token_cycles is not None:
            cpt = rec.cycles_per_token
            if cpt is not None and cpt > self.per_token_cycles:
                return False
        return True


@dataclasses.dataclass
class RequestRecord:
    """One request's lifecycle on the virtual clock."""

    uid: Optional[int]         # engine uid; None if rejected at admission
    arrival: float
    prompt_len: int
    max_new_tokens: int
    first_token: Optional[float] = None   # clock at end of its prefill
    finish: Optional[float] = None        # clock at its last decode
    decode_tokens: int = 0
    rejected: bool = False
    deferred: bool = False     # submitted while no slot was free
    # Post-mapped from the engine after the replay drains:
    refused: bool = False      # admission policy refused it (never ran)
    truncated: bool = False    # ended by the cache window, not EOS/budget
    preempted: int = 0         # evictions it suffered (paged engines)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token is None:
            return None
        return self.first_token - self.arrival

    @property
    def cycles_per_token(self) -> Optional[float]:
        """Mean decode latency per generated token (excludes prefill)."""
        if self.finish is None or self.first_token is None \
                or not self.decode_tokens:
            return None
        return (self.finish - self.first_token) / self.decode_tokens


@dataclasses.dataclass
class LoadReport:
    """Everything one :func:`run_load` produced."""

    records: List[RequestRecord]
    occupancy: List[dict]      # {"clock", "phase", "slots"} per engine step
    clock: float               # virtual cycles when the trace drained
    rejected: int
    deferred: int
    slo: Optional[SLO] = None  # the objective goodput was graded against

    def completed(self) -> List[RequestRecord]:
        return [r for r in self.records if r.finish is not None]

    # ------------------------------------------------------------------ #
    def summary(self, *, freq_hz: Optional[float] = None
                ) -> Dict[str, float]:
        """Tail-latency + occupancy summary.  Cycle keys always; ``_us``
        and throughput keys when ``freq_hz`` is given."""
        comp = self.completed()
        ttfts = [r.ttft for r in comp if r.ttft is not None]
        per_tok = [r.cycles_per_token for r in comp
                   if r.cycles_per_token is not None]
        slots = [e["slots"] for e in self.occupancy]
        decode_tokens = sum(r.decode_tokens for r in comp)
        truncated = sum(1 for r in comp if r.truncated)
        # window-truncated outputs are NOT successes; with an SLO set,
        # neither are completions outside its latency bounds
        good = [r for r in comp if not r.truncated]
        if self.slo is not None:
            good = [r for r in good if self.slo.met(r)]
        out: Dict[str, float] = {
            "requests": len(self.records),
            "completed": len(comp),
            "rejected": self.rejected,
            "deferred": self.deferred,
            "refused": sum(1 for r in self.records if r.refused),
            "truncated": truncated,
            "goodput": len(good),
            "preempted": sum(r.preempted for r in self.records),
            "decode_tokens": decode_tokens,
            "makespan_cycles": self.clock,
            "mean_occupancy": (sum(slots) / len(slots)) if slots else 0.0,
            "peak_occupancy": max(slots) if slots else 0,
        }
        for label, xs in (("ttft", ttfts), ("tok", per_tok)):
            for q in (50, 99):
                out[f"p{q}_{label}_cycles"] = (
                    float(np.percentile(xs, q)) if xs else 0.0
                )
        if freq_hz:
            for key in ("p50_ttft", "p99_ttft", "p50_tok", "p99_tok"):
                out[f"{key}_us"] = out[f"{key}_cycles"] / freq_hz * 1e6
            out["tokens_per_sec"] = (
                decode_tokens / (self.clock / freq_hz) if self.clock else 0.0
            )
        return out


def run_load(
    engine, backend, trace: Sequence[Arrival], *,
    max_queue: Optional[int] = None, seed: int = 0, metrics=None,
    max_steps: int = 100_000, slo: Optional[SLO] = None,
) -> LoadReport:
    """Replay an arrival trace through a live engine on a virtual clock.

    ``engine`` is a :class:`~repro_torch.serve.engine.ServeEngine`; ``backend``
    a :class:`~repro_torch.serve.legion_backend.LegionServeBackend` already
    attached to it (its caches price the steps).  The clock advances by
    the cycle model: standalone step cycles per prefill, overlapped
    engine-view cycles per batched decode.  Arrivals are submitted once
    the clock reaches them; with ``max_queue`` set, arrivals finding a
    full queue are **rejected** (never submitted), and any request
    submitted while all slots are busy counts as **deferred**.

    In-flight engines emit merged ``step`` events: the clock advances by
    the overlapped cycles of the merged prefill-chunk + decode Program.
    After the replay drains, ``Request.truncated`` and admission
    refusals are mapped back onto the records.

    ``metrics`` (optional, e.g. :class:`repro_torch.obs.metrics
    .MetricsRegistry`) receives ``load_*`` counters/histograms as the
    replay progresses.

    ``slo`` (optional :class:`SLO`) grades completions: the report's
    ``goodput`` then counts only requests finishing inside the latency
    objective.  Paged engines surface eviction pressure the same way —
    ``Request.preempted`` maps back onto the records (a preempted
    request's TTFT keeps its *first* prefill; the re-prefill only costs
    clock), and ``summary()["preempted"]`` totals the evictions.
    """
    trace = sorted(trace, key=lambda a: a.time)
    rng = np.random.default_rng(seed)
    vocab = int(engine.cfg.vocab)
    records: List[RequestRecord] = []
    by_uid: Dict[int, RequestRecord] = {}
    occupancy: List[dict] = []
    state = {"clock": 0.0}

    def observe(event: dict) -> None:
        if event["kind"] == "prefill":
            tokens = event["tokens"]
            cost = backend.step_tally(tokens, (tokens,)).cycles
            state["clock"] += cost
            rec = by_uid[event["uid"]]
            # a re-prefill after preemption costs clock like any prefill,
            # but only the FIRST prefill defines time-to-first-token
            if rec.first_token is None:
                rec.first_token = state["clock"]
                if metrics is not None:
                    metrics.histogram("load_ttft_cycles").observe(rec.ttft)
            if event.get("done"):     # finished at its prompt boundary
                rec.finish = state["clock"]
            occupancy.append({"clock": state["clock"], "phase": "prefill",
                              "slots": len(engine._active())})
            if metrics is not None:
                metrics.histogram("load_prefill_step_cycles").observe(cost)
        elif event["kind"] == "decode":
            uids = event["uids"]
            contexts = tuple(sorted(p + 1 for p in event["positions"]))
            _serial, overlapped = backend.step_pipeline(len(uids), contexts)
            state["clock"] += overlapped
            for uid in uids:
                rec = by_uid[uid]
                rec.decode_tokens += 1
                rec.finish = state["clock"]
            occupancy.append({"clock": state["clock"], "phase": "decode",
                              "slots": len(uids)})
            if metrics is not None:
                metrics.histogram("load_decode_step_cycles") \
                    .observe(overlapped)
                metrics.histogram("load_decode_batch").observe(len(uids))
        elif event["kind"] == "step":
            # in-flight: ONE merged step carries prefill chunks + decode;
            # the clock advances by the merged graph's overlapped cycles
            chunks = event["chunks"]
            uids = event["uids"]
            contexts = tuple(sorted(p + 1 for p in event["positions"]))
            shapes = tuple((c["tokens"], c["pos0"] + c["tokens"])
                           for c in chunks)
            _serial, overlapped = backend.step_pipeline_mixed(
                shapes, decode_m=len(uids), decode_contexts=contexts)
            state["clock"] += overlapped
            for c in chunks:
                if not c.get("last"):
                    continue
                rec = by_uid[c["uid"]]
                # chunked re-prefill keeps the original TTFT (see above)
                if rec.first_token is None:
                    rec.first_token = state["clock"]
                    if metrics is not None:
                        metrics.histogram("load_ttft_cycles") \
                            .observe(rec.ttft)
                if c.get("done"):      # finished at its prompt boundary
                    rec.finish = state["clock"]
            for uid in uids:
                rec = by_uid[uid]
                rec.decode_tokens += 1
                rec.finish = state["clock"]
            engaged = set(uids) | {c["uid"] for c in chunks}
            occupancy.append({"clock": state["clock"], "phase": "step",
                              "slots": len(engaged)})
            if metrics is not None:
                metrics.histogram("load_step_cycles").observe(overlapped)
                if uids:
                    metrics.histogram("load_decode_batch") \
                        .observe(len(uids))

    engine.step_observers.append(observe)
    rejected = deferred = 0
    i = 0
    steps = 0
    try:
        while i < len(trace) or engine.queue or engine._active():
            # idle engine: jump the clock forward to the next arrival
            if not engine.queue and not engine._active() \
                    and i < len(trace) and trace[i].time > state["clock"]:
                state["clock"] = trace[i].time
            # admit every arrival the clock has reached
            while i < len(trace) and trace[i].time <= state["clock"]:
                a = trace[i]
                i += 1
                if max_queue is not None \
                        and len(engine.queue) >= max_queue:
                    rejected += 1
                    records.append(RequestRecord(
                        uid=None, arrival=a.time, prompt_len=a.prompt_len,
                        max_new_tokens=a.max_new_tokens, rejected=True,
                    ))
                    continue
                waits = (len(engine._active()) + len(engine.queue)
                         >= engine.max_slots)
                prompt = rng.integers(1, vocab, size=a.prompt_len)
                req = engine.submit(prompt,
                                    max_new_tokens=max(a.max_new_tokens, 2))
                rec = RequestRecord(
                    uid=req.uid, arrival=a.time, prompt_len=a.prompt_len,
                    max_new_tokens=a.max_new_tokens, deferred=waits,
                )
                if waits:
                    deferred += 1
                records.append(rec)
                by_uid[req.uid] = rec
            if not engine.step():
                # nothing active and nothing admitted — only arrivals left
                if i >= len(trace):
                    break
                state["clock"] = max(state["clock"], trace[i].time)
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"load replay exceeded {max_steps} engine steps "
                    f"({i}/{len(trace)} arrivals submitted)"
                )
    finally:
        engine.step_observers.remove(observe)

    # post-map terminal flags the events don't carry: window truncation
    # (Request.truncated) and admission refusals (engine.refused)
    done_reqs = {r.uid: r for r in engine.finished}
    for uid, rec in by_uid.items():
        req = done_reqs.get(uid)
        if req is not None:
            if req.truncated:
                rec.truncated = True
            rec.preempted = req.preempted
    for req in getattr(engine, "refused", ()):
        rec = by_uid.get(req.uid)
        if rec is not None:
            rec.refused = True

    if metrics is not None:
        metrics.counter("load_requests").inc(len(records))
        metrics.counter("load_rejected").inc(rejected)
        metrics.counter("load_deferred").inc(deferred)
        preempt_total = sum(rec.preempted for rec in records)
        if preempt_total:
            metrics.counter("load_preempted").inc(preempt_total)
        metrics.gauge("load_clock_cycles").set(state["clock"])
        for rec in records:
            if rec.cycles_per_token is not None:
                metrics.histogram("load_cycles_per_token") \
                    .observe(rec.cycles_per_token)
    return LoadReport(records=records, occupancy=occupancy,
                      clock=state["clock"], rejected=rejected,
                      deferred=deferred, slo=slo)
