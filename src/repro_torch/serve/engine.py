"""Serving engine: prefill/decode steps + continuous-batching scheduler.

The port of ``repro.serve.engine``'s legacy mode: whole-prompt prefill at
admission and one batched decode step across the active slots.  The
engine runs a fixed number of *slots* (the batch dimension); requests
stream through slots as they finish (continuous batching).  Decode steps
take per-slot positions, so slots never run in lockstep.  The model runs
on the device of its :class:`~repro_torch.models.ModelAPI`.

In-flight batching (``prefill_chunk_tokens=``), paged KV (``paged_kv=``)
and admission policies (``admission=``) wait for the slice that ports
``paged_kv.py``, ``admission.py`` and ``forward_prefill_chunk``.
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


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    pos: int = 0                       # next write position in the cache


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
        for opt, val in (("prefill_chunk_tokens", prefill_chunk_tokens),
                         ("admission", admission), ("paged_kv", paged_kv)):
            if val is not None:
                raise NotImplementedError(
                    f"{opt}= is not ported yet (in-flight batching, paged "
                    "KV and admission come with a later slice; ROADMAP.md)"
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
        # Step observers: called after every prefill / batched decode with a
        # small event dict — the hook accelerator backends attach to (e.g.
        # repro_torch.serve.legion_backend drives each step's GEMMs through
        # the Legion runtime for traffic/cycle tallies).
        #   {"kind": "prefill", "uid": int, "tokens": prompt_len,
        #    "done": bool}              # completed at its prompt boundary
        #   {"kind": "decode",  "uids": [int, ...], "tokens": 1,
        #    "positions": [int, ...]}   # per-slot cache write position —
        #                               # the step attended pos+1 entries
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

    def _log_prefill(self, req: Request, plen: int) -> None:
        self.step_log.append({"phase": "prefill", "uid": req.uid,
                              "tokens": plen,
                              "slots": len(self._active())})
        if self.metrics is not None:
            self.metrics.counter("serve_prefill_steps").inc()
            self.metrics.counter("serve_prefill_tokens").inc(plen)
            self.metrics.histogram("serve_prompt_tokens").observe(plen)
            self.metrics.gauge("serve_slot_occupancy").set(
                len(self._active()) / self.max_slots)

    def _admit(self):
        """Fill free slots from the queue; prefill each admitted request
        alone.  Requests finishing at their prompt boundary (see
        :meth:`_first_token`) complete here and leave the slot free for
        the next queue entry."""
        for i, slot in enumerate(self.slots):
            if slot.request is not None:
                continue
            while self.queue:
                req = self.queue.pop(0)
                plen = len(req.prompt)
                # single-request prefill into this slot's cache lane
                single_cache = self.api.init_cache(1, self.max_seq)
                tokens = torch.from_numpy(req.prompt[None, :].astype(
                    np.int64)).to(self.device)
                logits, single_cache = self.api.prefill(
                    self.params, {"tokens": tokens}, single_cache)
                tok = self._sample(logits[:, -1])
                finished = self._first_token(req, int(tok[0]), plen)
                if not finished:
                    _write_slot(self.cache, single_cache, i)
                    slot.request = req
                    slot.pos = plen
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
        """One engine step: whole-prompt prefill at admission + one batched
        decode across the active slots.  Returns False when idle."""
        self._admit()
        active = self._active()
        if not active:
            return False
        logits = self._decode_step(active)
        self._notify({"kind": "decode", "tokens": 1,
                      "uids": [self.slots[i].request.uid for i in active],
                      "positions": [int(self.slots[i].pos) for i in active]})
        next_tok = self._sample(logits[:, -1])
        self._finish_decoded(active, next_tok)
        return True

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
                slot.request = None
                slot.pos = 0

    def run_until_done(self, max_steps: int = 10_000) -> List[Request]:
        steps = 0
        while (self.queue or self._active()) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished


def _write_slot(cache, single_cache, slot: int) -> None:
    """Copy a 1-lane prefilled cache into lane ``slot`` of the engine cache
    (in place; every stacked ``[L, B, ...]`` leaf's batch axis is dim 1)."""
    for full, single in zip(cache, single_cache):
        full[:, slot] = single[:, 0]
