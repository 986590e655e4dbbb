"""Paged KV cache — block allocator + the engine's paged cache view.

vLLM-style PagedAttention bookkeeping for the serve path: the KV pool is
a fixed number of ``page_tokens``-token pages, each request owns a *page
table* (ordered list of physical page ids), and capacity pressure is
resolved by evicting whole requests (preemption + re-prefill) rather
than by refusing work.

Two layers:

* :class:`PageAllocator` — pure bookkeeping.  A deterministic free list
  (lowest physical page id first), per-request page tables, and the
  alloc / extend / free / evict lifecycle with the invariants the
  property tests pin: no double-free, ``free + pinned == total`` always,
  and per-request waste (allocated minus logical tokens) strictly under
  one page.
* :class:`PagedKVCache` — the engine-facing view.  It owns an allocator
  and mediates every cache-lane write of :class:`~repro_torch.serve.engine
  .ServeEngine`, so a slot lane is only ever written through a
  reservation the allocator granted.

**Residency model (why outputs are bit-exact by construction).**  The
engine's numeric cache stays the contiguous ``[layers, slots, heads,
max_seq, head_dim]`` tensors, written in place — page ``p`` of a
resident request in slot ``s`` *is* lane ``s`` rows
``[p*page_tokens, (p+1)*page_tokens)``.
The allocator decides *which requests may be resident at all* (HBM-pool
admission), not where their bytes land; a physical page id models a slab
of the HBM pool, and the Legion layer prices its fetches page-granularly
(``repro_torch.core.workloads.GEMMWorkload.page_tokens`` →
``on_page_fetch`` events, last-page padding as traffic waste).  Scatter
/ gather indirection would change *addresses*, never *values* — so the
paged engine's outputs equal the contiguous engine's exactly, and the
test suite pins that including across forced preemptions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


class PageError(RuntimeError):
    """Allocator misuse: double free, unknown request, shrink, …"""


@dataclasses.dataclass(frozen=True)
class PageStats:
    """Point-in-time allocator occupancy (``free + pinned == total``)."""

    total_pages: int
    free_pages: int
    pinned_pages: int
    page_tokens: int
    active_requests: int
    waste_tokens: int        # sum over active requests of last-page padding
    evictions: int           # lifetime evict() count

    @property
    def pinned_tokens(self) -> int:
        return self.pinned_pages * self.page_tokens

    @property
    def waste_frac(self) -> float:
        """Padding share of the pinned pool (0.0 when empty)."""
        if not self.pinned_pages:
            return 0.0
        return self.waste_tokens / self.pinned_tokens


class PageAllocator:
    """Fixed-pool block allocator for KV pages.

    ``total_pages`` pages of ``page_tokens`` tokens each.  Pages are
    handed out lowest-id-first from a sorted free list, so identical
    call sequences produce identical page tables (determinism the
    engine's reproducibility tests rely on).

    Lifecycle per request ``uid``:

    * :meth:`alloc`\\ ``(uid, tokens)`` — reserve ``ceil(tokens /
      page_tokens)`` pages.  Atomic: on shortfall nothing is allocated
      and ``None`` returns (caller defers or preempts).
    * :meth:`extend`\\ ``(uid, tokens)`` — grow the reservation to cover
      ``tokens``; already-covered growth is free (the last page absorbs
      it).  Atomic like ``alloc``; shrinking raises.
    * :meth:`free`\\ ``(uid)`` — return every page; unknown ``uid``
      raises :class:`PageError` (no double-free).
    * :meth:`evict`\\ ``(uid)`` — ``free`` + eviction accounting, for
      preemption.

    :meth:`eviction_order` gives victims latest-allocated-first — the
    lowest-priority-running ordering the engine preempts by.
    """

    def __init__(self, total_pages: int, page_tokens: int) -> None:
        if total_pages < 1:
            raise ValueError(f"total_pages must be >= 1, got {total_pages}")
        if page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
        self.total_pages = total_pages
        self.page_tokens = page_tokens
        self._free: List[int] = list(range(total_pages - 1, -1, -1))
        # uid -> (page table, logical token length); insertion-ordered —
        # Python dicts preserve it, and eviction_order() walks it backwards.
        self._tables: Dict[int, List[int]] = {}
        self._lengths: Dict[int, int] = {}
        self.evictions = 0

    # ---- queries ------------------------------------------------------ #
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pinned_pages(self) -> int:
        return self.total_pages - len(self._free)

    def pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.page_tokens)

    def page_table(self, uid: int) -> Tuple[int, ...]:
        if uid not in self._tables:
            raise PageError(f"request {uid} holds no pages")
        return tuple(self._tables[uid])

    def tokens(self, uid: int) -> int:
        if uid not in self._lengths:
            raise PageError(f"request {uid} holds no pages")
        return self._lengths[uid]

    def holds(self, uid: int) -> bool:
        return uid in self._tables

    def waste_tokens(self, uid: int) -> int:
        """Last-page padding of one request: always ``< page_tokens``."""
        return (len(self.page_table(uid)) * self.page_tokens
                - self.tokens(uid))

    def eviction_order(self) -> List[int]:
        """Active uids, preferred victim first (latest-allocated first —
        the newest request has done the least work and re-prefills the
        cheapest)."""
        return list(reversed(self._tables))

    def stats(self) -> PageStats:
        return PageStats(
            total_pages=self.total_pages,
            free_pages=self.free_pages,
            pinned_pages=self.pinned_pages,
            page_tokens=self.page_tokens,
            active_requests=len(self._tables),
            waste_tokens=sum(
                len(t) * self.page_tokens - self._lengths[u]
                for u, t in self._tables.items()
            ),
            evictions=self.evictions,
        )

    # ---- lifecycle ---------------------------------------------------- #
    def _take(self, count: int) -> List[int]:
        return [self._free.pop() for _ in range(count)]

    def alloc(self, uid: int, tokens: int) -> Optional[Tuple[int, ...]]:
        if uid in self._tables:
            raise PageError(f"request {uid} already holds pages; "
                            f"use extend()")
        if tokens < 1:
            raise ValueError(f"tokens must be >= 1, got {tokens}")
        need = self.pages_needed(tokens)
        if need > len(self._free):
            return None
        self._tables[uid] = self._take(need)
        self._lengths[uid] = tokens
        return tuple(self._tables[uid])

    def extend(self, uid: int, tokens: int) -> bool:
        if uid not in self._tables:
            raise PageError(f"request {uid} holds no pages; use alloc()")
        if tokens < self._lengths[uid]:
            raise PageError(
                f"request {uid} cannot shrink from {self._lengths[uid]} to "
                f"{tokens} tokens"
            )
        grow = self.pages_needed(tokens) - len(self._tables[uid])
        if grow > len(self._free):
            return False
        if grow > 0:
            self._tables[uid].extend(self._take(grow))
        self._lengths[uid] = tokens
        return True

    def free(self, uid: int) -> int:
        """Release every page of ``uid``; returns the count released."""
        if uid not in self._tables:
            raise PageError(f"double free: request {uid} holds no pages")
        pages = self._tables.pop(uid)
        del self._lengths[uid]
        self._free.extend(pages)
        self._free.sort(reverse=True)   # keep lowest-id-first determinism
        return len(pages)

    def evict(self, uid: int) -> int:
        """Preemption: free ``uid``'s pages and count the eviction."""
        freed = self.free(uid)
        self.evictions += 1
        return freed


class PagedKVCache:
    """The engine's paged view over its contiguous KV cache.

    Construct with the pool geometry (or :meth:`from_budget` a
    :class:`~repro_torch.serve.kv_cache.CacheBudget` planned with
    ``page_tokens=``) and hand to ``ServeEngine(paged_kv=...)``.  The
    engine then routes admission (:meth:`admit`), per-decode-step growth
    (:meth:`extend`), retirement (:meth:`release`), preemption
    (:meth:`evict`) and every cache-lane write (:meth:`write_slot`)
    through this view — see the module docstring for why the numerics
    are bit-exact vs the contiguous engine.
    """

    def __init__(self, *, total_pages: int, page_tokens: int) -> None:
        self.allocator = PageAllocator(total_pages, page_tokens)
        self.page_tokens = page_tokens

    @classmethod
    def from_budget(cls, budget) -> "PagedKVCache":
        """From a ``kv_cache.plan(page_tokens=...)`` CacheBudget."""
        if not getattr(budget, "page_tokens", None):
            raise ValueError(
                "budget carries no page geometry; plan with page_tokens="
            )
        return cls(total_pages=budget.pages_total,
                   page_tokens=budget.page_tokens)

    # ---- allocator pass-through --------------------------------------- #
    def admit(self, uid: int, tokens: int) -> bool:
        """Reserve pages for a request entering prefill (optimistic —
        the whole prompt is pinned up front, vLLM-style)."""
        return self.allocator.alloc(uid, tokens) is not None

    def extend(self, uid: int, tokens: int) -> bool:
        return self.allocator.extend(uid, tokens)

    def release(self, uid: int) -> int:
        return self.allocator.free(uid)

    def evict(self, uid: int) -> int:
        return self.allocator.evict(uid)

    def holds(self, uid: int) -> bool:
        return self.allocator.holds(uid)

    def page_table(self, uid: int) -> Tuple[int, ...]:
        return self.allocator.page_table(uid)

    def page_tables(self, uids) -> List[Tuple[int, ...]]:
        """Per-slot tables in ``uids`` order — the shape
        ``lower_serve_batch(page_tables=...)`` validates against."""
        return [self.allocator.page_table(u) for u in uids]

    def eviction_order(self) -> List[int]:
        return self.allocator.eviction_order()

    def stats(self) -> PageStats:
        return self.allocator.stats()

    # ---- the cache view ------------------------------------------------ #
    def write_slot(self, cache, single_cache, slot: int, *, uid: int,
                   tokens: int):
        """Land a prefilled single lane into the batch cache through the
        page reservation: refuses the write unless ``uid`` holds pages
        covering ``tokens`` (page ``p`` of the reservation backs lane
        rows ``[p*page_tokens, (p+1)*page_tokens)``)."""
        if not self.allocator.holds(uid):
            raise PageError(
                f"request {uid} has no page reservation; admit() first"
            )
        covered = (len(self.allocator.page_table(uid)) * self.page_tokens)
        if tokens > covered:
            raise PageError(
                f"request {uid} writes {tokens} tokens but holds only "
                f"{covered} page-backed rows"
            )
        from repro_torch.serve.engine import _write_slot
        return _write_slot(cache, single_cache, slot)
