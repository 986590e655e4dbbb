"""Port parity: repro_torch.serve.paged_kv and the paged engine against
repro.serve.

The allocator is pure bookkeeping, so random lifecycle sequences must give
equal results, page tables, stats and errors (messages included) in both
packages.  The paged engine runs reduced BitNet-1.58B in float32 with a
page pool tight enough to force preemption and re-prefill, in legacy and
in-flight mode, beside the JAX engine on the same weights: greedy tokens,
``step_log``, preemption counts, every page table after every step and
the Legion backend's tallies (``page_fetches``, ``page_fetch_bytes``, ...)
must be equal.  The greedy argmax of the float32 logits agrees on these
seeds, as in tests/test_torch_serve.py.
"""
import dataclasses

import jax
import numpy as np
import pytest

import repro.core as jcore
import repro.serve as jserve
import repro_torch.configs as tconfigs
import repro_torch.core as tcore
import repro_torch.serve as tserve
from repro.configs import get_config, reduced
from repro.models import build_model as jax_build
from repro.serve.engine import prepare_params as jax_prepare
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.serve.engine import prepare_params

PACKAGES = (jserve, tserve)


# --------------------------------------------------------------------------- #
# PageAllocator: random lifecycles, op by op
# --------------------------------------------------------------------------- #

def _lifecycle(serve, seed: int, steps: int = 80):
    """A seeded random op sequence; every result, error and the tables and
    stats after each op, as plain values."""
    rng = np.random.default_rng(seed)
    total, page = int(rng.integers(2, 24)), int(rng.integers(1, 9))
    a = serve.PageAllocator(total, page)
    log = []
    next_uid = 0
    for _ in range(steps):
        op = rng.choice(["alloc", "extend", "free", "evict", "bad"])
        uid = int(rng.integers(0, next_uid + 1))
        toks = int(rng.integers(0, 4 * page))
        try:
            if op == "alloc":
                out = a.alloc(next_uid, toks)
                next_uid += 1
            elif op == "extend":
                out = a.extend(uid, toks)
            elif op == "free":
                out = a.free(uid)
            elif op == "evict":
                out = a.evict(uid)
            else:                         # re-alloc a uid that may hold
                out = a.alloc(uid, toks)
        except (serve.PageError, ValueError) as exc:
            out = (type(exc).__name__, str(exc))
        held = a.eviction_order()
        log.append((str(op), out, held,
                    {u: (a.page_table(u), a.tokens(u), a.waste_tokens(u))
                     for u in held},
                    dataclasses.asdict(a.stats())))
    return log


@pytest.mark.parametrize("seed", range(8))
def test_allocator_random_sequences_match_reference(seed):
    j, t = (_lifecycle(s, seed) for s in PACKAGES)
    assert t == j
    assert any(isinstance(entry[1], tuple) and entry[1][0] == "PageError"
               for entry in t), "the sequence should hit a PageError"


def test_allocator_constructor_errors_match():
    for args in ((0, 4), (4, 0)):
        msgs = []
        for serve in PACKAGES:
            with pytest.raises(ValueError) as exc:
                serve.PageAllocator(*args)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]


def _gating(serve):
    kv = serve.PagedKVCache(total_pages=4, page_tokens=8)
    assert kv.admit(5, 10)
    errors = []
    for uid, tokens in ((9, 4), (5, 17)):
        with pytest.raises(serve.PageError) as exc:
            kv.write_slot(None, None, 0, uid=uid, tokens=tokens)
        errors.append(str(exc.value))
    assert kv.extend(5, 17)
    return errors, kv.page_tables([5]), kv.release(5), kv.holds(5)


def test_write_slot_gating_errors_match():
    assert _gating(tserve) == _gating(jserve)


def test_from_budget_matches_reference():
    from repro.serve.kv_cache import plan as jplan
    from repro_torch.serve.kv_cache import plan as tplan
    jcfg = reduced(get_config("bitnet-1.58b"))
    tcfg = tconfigs.reduced(tconfigs.get_config("bitnet-1.58b"))
    kw = dict(batch=4, max_seq=64, hbm_bytes_per_chip=2 ** 20, chips=1,
              page_tokens=8)
    j = jserve.PagedKVCache.from_budget(jplan(jcfg, **kw))
    t = tserve.PagedKVCache.from_budget(tplan(tcfg, **kw))
    assert (t.allocator.total_pages, t.page_tokens) == \
        (j.allocator.total_pages, j.page_tokens)


# --------------------------------------------------------------------------- #
# The paged engine, through preemption, against the JAX engine
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def models():
    jcfg = reduced(get_config("bitnet-1.58b")).replace(dtype="float32")
    tcfg = tconfigs.reduced(tconfigs.get_config("bitnet-1.58b")).replace(
        dtype="float32")
    japi, tapi = jax_build(jcfg), build_model(tcfg, device="cpu")
    jp = japi.init(jax.random.PRNGKey(0))
    tp = prepare_params(params_from_jax(jax.tree.map(np.asarray, jp),
                                        device="cpu"))
    return {jserve: (jcfg, japi, jax_prepare(jp), jcore.dlegion(), {}),
            tserve: (tcfg, tapi, tp, tcore.dlegion(), {"device": "cpu"})}


def _paged_run(serve, models, *, chunk, total_pages):
    cfg, api, params, accel, kw = models[serve]
    paged = serve.PagedKVCache(total_pages=total_pages, page_tokens=4)
    eng = serve.ServeEngine(api, params, max_slots=3, max_seq=32,
                            paged_kv=paged, prefill_chunk_tokens=chunk)
    backend = serve.LegionServeBackend(accel, cfg, params, page_tokens=4,
                                       **kw).attach(eng)
    tables = []
    eng.step_observers.append(lambda _e: tables.append(
        {u: paged.page_table(u) for u in paged.eviction_order()}))
    rng = np.random.default_rng(0)
    for _ in range(6):
        eng.submit(rng.integers(1, cfg.vocab, rng.integers(4, 12)),
                   max_new_tokens=8)
    done = eng.run_until_done()
    return {
        "outputs": sorted((r.uid, r.output, r.preempted) for r in done),
        "step_log": eng.step_log,
        "preemptions": eng.preemptions,
        "tables": tables,
        "stats": paged.stats(),
        "backend": backend.summary(),
    }


@pytest.mark.parametrize("chunk", [None, 6])
def test_paged_engine_matches_reference_through_preemption(models, chunk):
    j = _paged_run(jserve, models, chunk=chunk, total_pages=8)
    t = _paged_run(tserve, models, chunk=chunk, total_pages=8)
    assert t["preemptions"] > 0, "the tight pool must evict"
    assert "preempt" in [e["phase"] for e in t["step_log"]]
    assert t["backend"]["page_fetches"] > 0
    assert t["stats"].pinned_pages == 0 and \
        t["stats"].evictions == t["preemptions"]
    for key in ("outputs", "step_log", "preemptions", "tables"):
        assert t[key] == j[key], key
    assert dataclasses.asdict(t["stats"]) == dataclasses.asdict(j["stats"])
    assert t["backend"] == j["backend"]


@pytest.mark.parametrize("chunk", [None, 6])
def test_paged_engine_equals_contiguous_engine(models, chunk):
    """The port's own bit-exactness gate: a tight pool (preempting) and an
    ample one give the contiguous engine's tokens exactly."""
    cfg, api, params, _accel, _kw = models[tserve]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, rng.integers(4, 12))
               for _ in range(6)]

    def run(paged):
        eng = tserve.ServeEngine(api, params, max_slots=3, max_seq=32,
                                 paged_kv=paged, prefill_chunk_tokens=chunk)
        for p in prompts:
            eng.submit(p, max_new_tokens=8)
        return eng, {r.uid: r.output for r in eng.run_until_done()}

    _e0, ref = run(None)
    e1, ample = run(tserve.PagedKVCache(total_pages=64, page_tokens=4))
    e2, tight = run(tserve.PagedKVCache(total_pages=8, page_tokens=4))
    assert ample == ref and e1.preemptions == 0
    assert tight == ref and e2.preemptions > 0


def test_paged_engine_rejects_undersized_pool(models):
    msgs = []
    for serve in PACKAGES:
        _cfg, api, params, _accel, _kw = models[serve]
        with pytest.raises(ValueError, match="page") as exc:
            serve.ServeEngine(api, params, max_slots=2, max_seq=32,
                              paged_kv=serve.PagedKVCache(total_pages=7,
                                                          page_tokens=4))
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
