"""Serving engine: prefill/decode steps + continuous-batching scheduler.

The port of ``repro.serve.engine``.  The engine runs a fixed number of
*slots* (the batch dimension); requests stream through slots as they
finish (continuous batching).  Decode steps take per-slot positions, so
slots never run in lockstep.  The model runs on the device of its
:class:`~repro_torch.models.ModelAPI`.

Two modes, as in the JAX package: legacy (whole-prompt prefill at
admission, then one batched decode per step) and in-flight
(``prefill_chunk_tokens=``: prefill chunks and the batched decode merge
into one step).  Either mode takes a paged KV pool (``paged_kv=``, with
preemption and re-prefill under page pressure) and an admission policy
(``admission=``).  Unlike the JAX package, the model writes its cache in
place: the engine keeps one batch cache and one staging lane per
prefilling slot, and never rebuilds them.

Per-family notes: dense/moe/vlm use the KV cache (the engine's prefill
passes tokens only, so a VLM with patches is driven through its
``ModelAPI`` directly); ssm/hybrid carry O(1) recurrent state (their
``pos`` only drives RoPE in the hybrid's shared attention) and have no
chunked prefill; an encoder has no decode step and is refused.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # [len] int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # Ended by the cache window (slot.pos hit max_seq), not by EOS or the
    # token budget — a cut-off output, not a natural completion.
    truncated: bool = False
    # Refused by the admission policy (never prefilled; no output).
    refused: bool = False
    # Times this request was evicted under KV-page pressure and re-queued
    # for re-prefill (paged engines only; see repro_torch.serve.paged_kv).
    preempted: int = 0


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    pos: int = 0                       # next write position in the cache
    # In-flight (chunked) prefill state: prompt tokens already written into
    # the staging cache, and the single-lane staging cache itself (None
    # once the slot is decode-ready or free).
    filled: int = 0
    staging: object = None
    # The token array being prefilled: the request's prompt, or — after a
    # preemption — prompt + output[:-1] (the resume re-prefill; the last
    # sampled token stays the decode feed).  None once decode-ready.
    tokens: Optional[np.ndarray] = None


_PROJECTIONS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "out_proj")


def prepare_params(params, *, ternary: bool = True):
    """Offline weight transform for serving: apply the BitNet ternary
    quantization ONCE (quantize -> dequantize), so the serve graph runs
    plain matmuls over already-quantized values.  Each stacked ``[L, ...]``
    projection leaf is quantized as one tensor, as in the JAX package."""
    if not ternary:
        return params
    from repro_torch.quant.bitnet import quantize_weight_ternary

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if node.ndim >= 2 and (name.startswith("in_proj")
                               or name in _PROJECTIONS):
            qv, gamma = quantize_weight_ternary(node)
            return qv.to(node.dtype) * gamma.to(node.dtype)
        return node

    return walk(params)


class ServeEngine:
    """Continuous-batching engine over a registry ModelAPI."""

    def __init__(self, api, params, *, max_slots: int = 4,
                 max_seq: int = 512, greedy: bool = True,
                 temperature: float = 1.0, seed: int = 0,
                 metrics=None, prefill_chunk_tokens: Optional[int] = None,
                 admission=None, paged_kv=None):
        if api.decode is None:
            raise ValueError(f"{api.cfg.name} is encoder-only; no decode")
        if prefill_chunk_tokens is not None:
            if prefill_chunk_tokens < 1:
                raise ValueError(
                    f"prefill_chunk_tokens must be >= 1, got "
                    f"{prefill_chunk_tokens}"
                )
            if api.prefill_chunk is None:
                raise ValueError(
                    f"{api.cfg.name} has no chunked prefill "
                    f"(api.prefill_chunk is None); only decoder "
                    f"transformers support in-flight batching"
                )
        self.api = api
        self.cfg = api.cfg
        self.device = api.device
        self.params = params
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.greedy = greedy
        self.temperature = temperature
        # non-greedy sampling draws from this generator, on the model's
        # device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.slots = [_Slot() for _ in range(max_slots)]
        self.cache = api.init_cache(max_slots, max_seq)
        self._next_uid = 0
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        # Requests the admission policy refused outright (never prefilled;
        # not in ``finished`` — refusal is not a completion).
        self.refused: List[Request] = []
        # In-flight batching: chunk prefill into fixed token-budget slices
        # and merge them with the batched decode slots into ONE engine step.
        # None = legacy mode: whole prompts prefill alone at admission.
        self.prefill_chunk_tokens = prefill_chunk_tokens
        # Live admission policy (duck-typed: ``decide(engine, request) ->
        # "admit" | "defer" | "refuse"``, e.g. repro_torch.serve.admission
        # .LiveAdmission).  None admits whenever a slot is free.
        self.admission = admission
        # Paged KV mode (repro_torch.serve.paged_kv.PagedKVCache): requests
        # pin whole pages at admission, decode steps extend page by page,
        # and page-pool exhaustion preempts the lowest-priority running slot
        # (pages freed, request re-queued at the head for re-prefill).
        # None = the idealized contiguous max_slots x max_seq layout.
        self.paged_kv = paged_kv
        self.preemptions = 0
        if paged_kv is not None:
            alloc = paged_kv.allocator
            if alloc.pages_needed(max_seq) > alloc.total_pages:
                # a lone request could then never grow to max_seq — the
                # preemption loop would starve with nothing left to evict
                raise ValueError(
                    f"page pool of {alloc.total_pages} x "
                    f"{alloc.page_tokens}-token pages cannot back one "
                    f"max_seq={max_seq} request; need >= "
                    f"{alloc.pages_needed(max_seq)} pages"
                )
        # Step observers: called after every prefill / batched decode with a
        # small event dict — the hook accelerator backends attach to (e.g.
        # repro_torch.serve.legion_backend drives each step's GEMMs through
        # the Legion runtime for traffic/cycle tallies).
        #   {"kind": "prefill", "uid": int, "tokens": prompt_len,
        #    "done": bool}              # completed at its prompt boundary
        #   {"kind": "decode",  "uids": [int, ...], "tokens": 1,
        #    "positions": [int, ...]}   # per-slot cache write position —
        #                               # the step attended pos+1 entries
        # In-flight mode emits ONE merged event per engine step instead:
        #   {"kind": "step",
        #    "chunks": [{"uid", "tokens", "pos0", "last", "done"}, ...],
        #    "uids": [...], "tokens": 1, "positions": [...]}
        # where each chunk wrote ``tokens`` prompt tokens at offset
        # ``pos0``, "last" marks a prompt-completing chunk and "done" a
        # request that finished at admission without taking a decode slot;
        # "uids"/"positions" are the step's batched decode.
        self.step_observers: List[Callable[[dict], None]] = []
        # Batch occupancy per decode step (len(uids) of each event).
        self.decode_batch_sizes: List[int] = []
        # Per-step phase + active-slot history covering prefill AND decode
        # ({"phase", "slots", "tokens"[, "uid"]}).
        self.step_log: List[Dict[str, int]] = []
        # Duck-typed metrics registry; None disables serve_* metrics.
        self.metrics = metrics

    # ------------------------------------------------------------------ #
    def submit(self, prompt: np.ndarray, *, max_new_tokens: int = 16,
               eos_id: Optional[int] = None) -> Request:
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(
                f"prompt must be a non-empty 1-D token array; got shape "
                f"{prompt.shape}"
            )
        if len(prompt) > self.max_seq:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds max_seq="
                f"{self.max_seq}; it can never fit a cache lane"
            )
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}"
            )
        # monotonic uid: uids key per-request maps (legion_backend)
        req = Request(uid=self._next_uid, prompt=prompt,
                      max_new_tokens=max_new_tokens, eos_id=eos_id)
        self._next_uid += 1
        self.queue.append(req)
        return req

    # ------------------------------------------------------------------ #
    def _next_admittable(self) -> Optional[Request]:
        """Pop the next queue entry past the admission policy.

        Refusals pop, flag, and land in :attr:`refused`; a deferral stops
        admission for this step (the queue head stays put).  Both are
        counted in ``step_log`` and the metrics registry.
        """
        while self.queue:
            req = self.queue[0]
            action = ("admit" if self.admission is None
                      else self.admission.decide(self, req))
            if action == "admit":
                return self.queue.pop(0)
            if action == "refuse":
                self.queue.pop(0)
                req.refused = True
                req.done = True
                self.refused.append(req)
                self.step_log.append({"phase": "refuse", "uid": req.uid,
                                      "tokens": len(req.prompt),
                                      "slots": len(self._active())})
                if self.metrics is not None:
                    self.metrics.counter("serve_admission_refused").inc()
                continue
            if action == "defer":
                self.step_log.append({"phase": "defer", "uid": req.uid,
                                      "tokens": len(req.prompt),
                                      "slots": len(self._active())})
                if self.metrics is not None:
                    self.metrics.counter("serve_admission_deferred").inc()
                return None
            raise ValueError(
                f"admission policy returned {action!r}; expected 'admit', "
                f"'defer' or 'refuse'"
            )
        return None

    def _first_token(self, req: Request, tok: int, plen: int) -> bool:
        """Record the prefill-sampled token and apply the prompt-boundary
        completion rules: EOS sampled at prefill, a 1-token budget, or a
        prompt filling the whole cache window all finish the request here —
        it never occupies a decode slot.  Returns True if finished."""
        req.output.append(tok)
        hit_eos = req.eos_id is not None and tok == req.eos_id
        full = plen >= self.max_seq   # no cache row left for a decode write
        if req.max_new_tokens <= 1 or hit_eos or full:
            req.done = True
            req.truncated = full and not hit_eos and req.max_new_tokens > 1
            self.finished.append(req)
            return True
        return False

    def _log_prefill(self, req: Request, plen: int, *,
                     count_tokens: bool = True) -> None:
        self.step_log.append({"phase": "prefill", "uid": req.uid,
                              "tokens": plen,
                              "slots": len(self._active())})
        if self.metrics is not None:
            self.metrics.counter("serve_prefill_steps").inc()
            if count_tokens:
                self.metrics.counter("serve_prefill_tokens").inc(plen)
            self.metrics.histogram("serve_prompt_tokens").observe(plen)
            self.metrics.gauge("serve_slot_occupancy").set(
                len(self._active()) / self.max_slots)

    # ---- paged-KV plumbing (no-ops when self.paged_kv is None) -------- #
    @staticmethod
    def _resume_tokens(req: Request) -> np.ndarray:
        """The tokens a (re-)prefill writes: the prompt, plus — after a
        preemption — every sampled token but the last (which stays the
        decode feed, exactly as if the eviction never happened)."""
        if not req.output:
            return req.prompt
        return np.concatenate(
            [req.prompt, np.asarray(req.output[:-1], np.int32)])

    def _page_admit(self, req: Request, tokens: int) -> bool:
        """Pin the request's prefill pages; on pool shortfall the request
        returns to the queue head (admission waits for pages, it does not
        preempt — only decode-side growth does)."""
        if self.paged_kv is None:
            return True
        if self.paged_kv.admit(req.uid, tokens):
            return True
        self.queue.insert(0, req)
        self.step_log.append({"phase": "defer_page", "uid": req.uid,
                              "tokens": tokens,
                              "slots": len(self._active())})
        if self.metrics is not None:
            self.metrics.counter("serve_page_deferred").inc()
        return False

    def _page_release(self, req: Request) -> None:
        if self.paged_kv is not None and self.paged_kv.holds(req.uid):
            self.paged_kv.release(req.uid)

    def _land(self, i: int, req: Request, lane, plen: int) -> None:
        """Copy a prefilled single lane into batch lane ``i`` — through the
        page reservation on paged engines."""
        if self.paged_kv is not None:
            self.cache = self.paged_kv.write_slot(self.cache, lane, i,
                                                  uid=req.uid, tokens=plen)
        else:
            self.cache = _write_slot(self.cache, lane, i)

    def _preempt(self, i: int) -> None:
        """Evict slot ``i``: free its pages, count the preemption, and
        re-queue the request at the head for re-prefill.  The batch lane
        keeps its rows until the next request lands there, as in the JAX
        package."""
        slot = self.slots[i]
        req = slot.request
        self.paged_kv.evict(req.uid)
        req.preempted += 1
        self.preemptions += 1
        slot.request = None
        slot.pos = 0
        slot.filled = 0
        slot.staging = None
        slot.tokens = None
        self.queue.insert(0, req)
        self.step_log.append({"phase": "preempt", "uid": req.uid,
                              "tokens": len(req.output),
                              "slots": len(self._active())})
        if self.metrics is not None:
            self.metrics.counter("serve_preempted_total").inc()
        st = getattr(self.admission, "stats", None)
        if st is not None and hasattr(st, "preempted"):
            st.preempted += 1

    def _preempt_victim(self, exclude_uid: int) -> Optional[int]:
        """Slot index to evict: the latest-admitted page holder other
        than ``exclude_uid`` (lowest-priority running request)."""
        by_uid = {s.request.uid: i for i, s in enumerate(self.slots)
                  if s.request is not None}
        for uid in self.paged_kv.eviction_order():
            if uid != exclude_uid and uid in by_uid:
                return by_uid[uid]
        return None

    def _ensure_kv(self, active: List[int]) -> List[int]:
        """Grow every decoding slot's page reservation to cover this
        step's cache write (``pos + 1`` tokens), evicting lower-priority
        slots under pool pressure.  Returns ``active`` minus any slots
        preempted along the way."""
        if self.paged_kv is None:
            return active
        for i in active:
            slot = self.slots[i]
            if slot.request is None:     # preempted by an earlier slot
                continue
            uid = slot.request.uid
            while not self.paged_kv.extend(uid, slot.pos + 1):
                victim = self._preempt_victim(uid)
                if victim is None:
                    raise RuntimeError(
                        f"request {uid} cannot grow its KV pages with "
                        f"nothing left to evict (pool too small?)"
                    )
                self._preempt(victim)
        if self.metrics is not None:
            st = self.paged_kv.stats()
            self.metrics.gauge("serve_page_pinned").set(st.pinned_pages)
            self.metrics.gauge("serve_page_free").set(st.free_pages)
            self.metrics.gauge("serve_page_waste_tokens").set(
                st.waste_tokens)
        return [i for i in active if self.slots[i].request is not None]

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(toks, np.int64)[None, :]).to(
            self.device)

    def _admit(self):
        """Fill free slots from the queue; prefill each admitted request.

        Legacy (whole-prompt) path: each admitted prompt prefills alone.
        Requests finishing at their prompt boundary (see
        :meth:`_first_token`) complete here and leave the slot free for
        the next queue entry.  Paged engines pin the prefill's pages
        first (a shortfall leaves the request queued) and re-prefill
        ``prompt + output[:-1]`` for requests resuming after preemption.
        """
        for i, slot in enumerate(self.slots):
            if slot.request is not None:
                continue
            while True:
                req = self._next_admittable()
                if req is None:
                    return
                tokens = self._resume_tokens(req)
                plen = len(tokens)
                if not self._page_admit(req, plen):
                    return
                # single-request prefill into a fresh lane
                single_cache = self.api.init_cache(1, self.max_seq)
                logits, single_cache = self.api.prefill(
                    self.params, {"tokens": self._tokens(tokens)},
                    single_cache)
                finished = False
                # a resume re-prefill's sample duplicates output[-1] (same
                # cache prefix): drop it and rejoin the decode loop
                if not req.output:
                    tok = self._sample(logits[:, -1])
                    finished = self._first_token(req, int(tok[0]), plen)
                if not finished:
                    self._land(i, req, single_cache, plen)
                    slot.request = req
                    slot.pos = plen
                else:
                    self._page_release(req)
                self._log_prefill(req, plen)
                self._notify({"kind": "prefill", "uid": req.uid,
                              "tokens": plen, "done": finished})
                if not finished:
                    break          # slot taken; move to the next free one

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """Next tokens of ``[B, V]`` logits, as a host int array."""
        if self.greedy:
            tok = torch.argmax(logits, dim=-1)
        else:
            probs = torch.softmax(
                logits.to(torch.float32) / self.temperature, dim=-1)
            tok = torch.multinomial(probs, 1,
                                    generator=self.generator)[:, 0]
        return tok.to(torch.int32).cpu().numpy()

    def _active(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.request is not None]

    def _notify(self, event: dict) -> None:
        for fn in self.step_observers:
            fn(event)

    # ------------------------------------------------------------------ #
    def step(self):
        """One engine step.

        Legacy mode: whole-prompt prefill at admission + one batched
        decode across the active slots.  In-flight mode
        (``prefill_chunk_tokens=``): prefill chunks and the batched decode
        run as ONE merged step (a single ``{"kind": "step"}`` event — the
        backend schedules both phases through one merged Program).
        Returns False when idle.
        """
        if self.prefill_chunk_tokens is not None:
            return self._step_inflight()
        return self._step_legacy()

    def _decode_step(self, active: List[int]):
        """Run the batched decode over ``active`` slot indices; returns
        the step logits (sampling happens after observers fire)."""
        tokens = np.zeros((self.max_slots,), np.int64)
        pos = np.zeros((self.max_slots,), np.int64)
        for i in active:
            slot = self.slots[i]
            tokens[i] = slot.request.output[-1]
            pos[i] = slot.pos
        logits, self.cache = self.api.decode(
            self.params, torch.from_numpy(tokens).to(self.device),
            self.cache, torch.from_numpy(pos).to(self.device))
        self.decode_batch_sizes.append(len(active))
        self.step_log.append({"phase": "decode", "tokens": len(active),
                              "slots": len(self._active())})
        if self.metrics is not None:
            self.metrics.counter("serve_decode_steps").inc()
            self.metrics.counter("serve_decode_tokens").inc(len(active))
            self.metrics.histogram("serve_batch_size").observe(len(active))
            self.metrics.gauge("serve_slot_occupancy").set(
                len(self._active()) / self.max_slots)
        return logits

    def _finish_decoded(self, active: List[int], next_tok) -> None:
        """Append sampled tokens and retire finished slots — EOS and
        token-budget completions, plus window truncations
        (``Request.truncated``) when ``slot.pos`` hits the cache edge."""
        for i in active:
            slot = self.slots[i]
            req = slot.request
            req.output.append(int(next_tok[i]))
            slot.pos += 1
            hit_eos = req.eos_id is not None and next_tok[i] == req.eos_id
            full = slot.pos >= self.max_seq - 1
            if len(req.output) >= req.max_new_tokens or hit_eos or full:
                req.done = True
                req.truncated = (full and not hit_eos
                                 and len(req.output) < req.max_new_tokens)
                self.finished.append(req)
                self._page_release(req)
                slot.request = None
                slot.pos = 0

    def _step_legacy(self):
        """Admission (whole-prompt prefills) + one batched decode step
        across all active slots."""
        self._admit()
        active = self._ensure_kv(self._active())
        if not active:
            return False
        logits = self._decode_step(active)
        self._notify({"kind": "decode", "tokens": 1,
                      "uids": [self.slots[i].request.uid for i in active],
                      "positions": [int(self.slots[i].pos) for i in active]})
        next_tok = self._sample(logits[:, -1])
        self._finish_decoded(active, next_tok)
        return True

    # ------------------------------------------------------------------ #
    # In-flight batching: prefill chunks + decode in one merged step
    # ------------------------------------------------------------------ #
    def _admit_inflight(self):
        """Assign free slots to queued requests (admission-gated) without
        running any prefill — chunks advance inside the merged step.
        Paged engines pin the whole (re-)prefill's pages up front.  Each
        prefilling slot stages into a lane of its own."""
        for slot in self.slots:
            if slot.request is not None:
                continue
            req = self._next_admittable()
            if req is None:
                return
            tokens = self._resume_tokens(req)
            if not self._page_admit(req, len(tokens)):
                return
            slot.request = req
            slot.pos = 0
            slot.filled = 0
            slot.tokens = tokens
            slot.staging = self.api.init_cache(1, self.max_seq)

    def _advance_chunks(self) -> List[dict]:
        """Advance every prefilling slot by one chunk, oldest slot first,
        until the step's ``prefill_chunk_tokens`` budget is spent."""
        budget = self.prefill_chunk_tokens
        chunks: List[dict] = []
        for i, slot in enumerate(self.slots):
            if budget <= 0:
                break
            req = slot.request
            if req is None or slot.staging is None:
                continue
            fill = slot.tokens
            plen = len(fill)
            c = min(budget, plen - slot.filled)
            pos0 = slot.filled
            logits, slot.staging = self.api.prefill_chunk(
                self.params, self._tokens(fill[pos0:pos0 + c]),
                slot.staging, pos0)
            slot.filled += c
            budget -= c
            self.step_log.append({"phase": "prefill_chunk", "uid": req.uid,
                                  "tokens": c,
                                  "slots": len(self._active())})
            if self.metrics is not None:
                self.metrics.counter("serve_prefill_chunks").inc()
                self.metrics.counter("serve_prefill_tokens").inc(c)
            last = slot.filled >= plen
            done = False
            if last:
                # a resume re-prefill's sample duplicates output[-1] (same
                # cache prefix): discard it, rejoin the decode loop
                if not req.output:
                    tok = self._sample(logits[:, -1])
                    done = self._first_token(req, int(tok[0]), plen)
                if done:
                    self._page_release(req)
                    slot.request = None
                else:
                    # decode-ready: land the staged lane in the batch cache
                    self._land(i, req, slot.staging, plen)
                    slot.pos = plen
                slot.staging = None
                slot.filled = 0
                slot.tokens = None
                self._log_prefill(req, plen, count_tokens=False)
            chunks.append({"uid": req.uid, "tokens": c, "pos0": pos0,
                           "last": last, "done": done})
        return chunks

    def _step_inflight(self):
        """One in-flight step: admit, advance prefill chunks under the
        token budget, batch-decode the decode-ready slots, and emit a
        single merged ``step`` event covering both phases."""
        self._admit_inflight()
        chunks = self._advance_chunks()
        active = self._ensure_kv([i for i in self._active()
                                  if self.slots[i].staging is None])
        if not chunks and not active:
            return False
        logits = self._decode_step(active) if active else None
        self._notify({
            "kind": "step", "chunks": chunks, "tokens": 1,
            "uids": [self.slots[i].request.uid for i in active],
            "positions": [int(self.slots[i].pos) for i in active],
        })
        if active:
            self._finish_decoded(active, self._sample(logits[:, -1]))
        return True

    def run_until_done(self, max_steps: int = 10_000) -> List[Request]:
        steps = 0
        while (self.queue or self._active()) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished


def _write_slot(cache, single_cache, slot: int):
    """Copy a 1-lane prefilled cache into lane ``slot`` of the engine cache
    (in place; every stacked ``[L, B, ...]`` leaf's batch axis is dim 1).
    Returns ``cache``, the same tensors."""
    for full, single in zip(cache, single_cache):
        full[:, slot] = single[:, 0]
    return cache
