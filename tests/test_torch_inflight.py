"""Port parity: chunked prefill, the in-flight engine and LiveAdmission.

``forward_prefill_chunk`` is held in float32 against the port's own whole
prefill and against the JAX package's ``prefill_chunk`` on reduced
qwen3-1.7b (no quantization) and reduced BitNet-1.58B: logits and every
cache leaf within atol 1e-4 (float32 summed in other orders: the two
sides agree to ~1e-6 on these inputs).  Neither package is bit-equal
between chunked and whole prefill (the JAX package's
``test_prefill_chunk_bit_exact`` fails for that reason); the port is held
at the same float32 tolerance on both comparisons.  A chunk writes rows
``[pos0, pos0 + C)`` of its lane in place and no other row.

The in-flight engine must emit the legacy engine's greedy tokens, and the
JAX in-flight engine's tokens and ``step_log``.  ``LiveAdmission`` under a
tight HBM budget must make the JAX policy's decisions (``step_log``
holds every admit, defer and refuse) and keep equal ``AdmissionStats``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

ATOL = 1e-4
CHUNK_MODELS = {"qwen3-1.7b": "none", "bitnet-1.58b": "bitnet"}


def _pair(arch, quantization, seed=1, prepared=False):
    jcfg = reduced(get_config(arch)).replace(dtype="float32",
                                             quantization=quantization)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch)).replace(
        dtype="float32", quantization=quantization)
    japi, tapi = jax_build(jcfg), build_model(tcfg, device="cpu")
    jp = japi.init(jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    if prepared:
        jp, tp = jax_prepare(jp), prepare_params(tp)
    return (jcfg, japi, jp), (tcfg, tapi, tp)


@pytest.fixture(scope="module", params=sorted(CHUNK_MODELS))
def chunk_models(request):
    return _pair(request.param, CHUNK_MODELS[request.param])


PROMPT = np.arange(1, 13, dtype=np.int64)[None]          # 12 tokens
CHUNKS = (5, 4, 3)                                       # uneven chunks


def _port_chunked(tapi, tp, cache):
    pos0 = 0
    for c in CHUNKS:
        lg, cache = tapi.prefill_chunk(
            tp, torch.from_numpy(PROMPT[:, pos0:pos0 + c]), cache, pos0)
        pos0 += c
    return lg, cache


def test_chunked_prefill_against_whole_prefill(chunk_models):
    _, (tcfg, tapi, tp) = chunk_models
    lg_whole, whole = tapi.prefill(tp, {"tokens": torch.from_numpy(PROMPT)},
                                   tapi.init_cache(1, 32))
    lg, cache = _port_chunked(tapi, tp, tapi.init_cache(1, 32))
    np.testing.assert_allclose(lg.numpy(), lg_whole.numpy(), rtol=0,
                               atol=ATOL)
    for a, b in zip(cache, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=ATOL)
    # decode continues alike from either cache
    tok = torch.argmax(lg_whole[:, -1], dim=-1)
    lg_a, _ = tapi.decode(tp, tok, whole, 12)
    lg_b, _ = tapi.decode(tp, tok, cache, 12)
    np.testing.assert_allclose(lg_b.numpy(), lg_a.numpy(), rtol=0,
                               atol=ATOL)


def test_chunked_prefill_against_reference(chunk_models):
    (jcfg, japi, jp), (tcfg, tapi, tp) = chunk_models
    jcache, pos0 = japi.init_cache(1, 32), 0
    for c in CHUNKS:
        jlg, jcache = japi.prefill_chunk(
            jp, jnp.asarray(PROMPT[:, pos0:pos0 + c].astype(np.int32)),
            jcache, pos0)
        pos0 += c
    lg, cache = _port_chunked(tapi, tp, tapi.init_cache(1, 32))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=0,
                               atol=ATOL)
    for a, b in zip(cache, jcache):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL)


def test_chunk_writes_only_its_rows(chunk_models):
    """The port's cache is written in place: a chunk at ``pos0`` touches
    rows [pos0, pos0 + C) of the lane it is given and nothing else."""
    _, (tcfg, tapi, tp) = chunk_models
    cache = tapi.init_cache(1, 32)
    for leaf in cache:
        leaf.fill_(7.0)
    before = [leaf.clone() for leaf in cache]
    _lg, out = tapi.prefill_chunk(tp, torch.from_numpy(PROMPT[:, :4]),
                                  cache, 5)
    assert all(a is b for a, b in zip(out, cache))
    for a, b in zip(out, before):
        changed = (a != b).any(dim=(0, 1, 2, 4))       # [S_max] rows
        assert changed[5:9].all()
        assert not changed[:5].any() and not changed[9:].any()


# --------------------------------------------------------------------------- #
# The in-flight engine
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def served():
    return _pair("bitnet-1.58b", "bitnet", seed=0, prepared=True)


PROMPTS = [np.arange(1, 4 + 3 * i) for i in range(5)]    # 3..15 tokens


def _engine_run(serve, api, params, chunk, **kw):
    eng = serve.ServeEngine(api, params, max_slots=3, max_seq=64,
                            prefill_chunk_tokens=chunk, **kw)
    reqs = [eng.submit(p, max_new_tokens=4 + i % 3)
            for i, p in enumerate(PROMPTS)]
    eng.run_until_done()
    return eng, [r.output for r in reqs]


@pytest.mark.parametrize("chunk", [4, 7])
def test_inflight_engine_matches_legacy(served, chunk):
    _, (tcfg, tapi, tp) = served
    _e, legacy = _engine_run(tserve, tapi, tp, None)
    eng, inflight = _engine_run(tserve, tapi, tp, chunk)
    assert inflight == legacy
    assert any(e["phase"] == "prefill_chunk" for e in eng.step_log)


@pytest.mark.parametrize("chunk", [4, 7])
def test_inflight_engine_matches_reference(served, chunk):
    (jcfg, japi, jp), (tcfg, tapi, tp) = served
    jeng, jout = _engine_run(jserve, japi, jp, chunk)
    teng, tout = _engine_run(tserve, tapi, tp, chunk)
    assert tout == jout
    assert teng.step_log == jeng.step_log
    assert teng.decode_batch_sizes == jeng.decode_batch_sizes


def test_inflight_requires_chunked_prefill_support():
    cfg = tconfigs.reduced(tconfigs.get_config("mamba2-130m"))
    api = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk"):
        tserve.ServeEngine(api, {}, prefill_chunk_tokens=8)
    cfg2 = tconfigs.reduced(tconfigs.get_config("smollm-360m"))
    with pytest.raises(ValueError, match=">= 1"):
        tserve.ServeEngine(build_model(cfg2, device="cpu"), {},
                           prefill_chunk_tokens=0)


# --------------------------------------------------------------------------- #
# LiveAdmission under a tight HBM budget
# --------------------------------------------------------------------------- #

ADMISSION = {
    # 44 KV rows of capacity at 1 KiB a row: the 40-token prompt (+8)
    # never fits (refuse); two ~20-row requests fill it (defer the rest)
    "kv": dict(hbm_rows=44, max_pending_cycles=None, chunk=None),
    "kv-inflight": dict(hbm_rows=44, max_pending_cycles=None, chunk=6),
    # a 1e4-cycle horizon holds a handful of outstanding decode tokens at
    # the measured overlapped rate: later admissions defer on rate
    "rate": dict(hbm_rows=400, max_pending_cycles=1e4, chunk=None),
}


def _admitted_run(serve, accel, models, spec, kw):
    cfg, api, params = models
    backend = serve.LegionServeBackend(accel, cfg, params, **kw)
    bpt = serve.kv_bytes_per_token(cfg, 2)
    policy = serve.LiveAdmission(
        backend, hbm_bytes_per_chip=spec["hbm_rows"] * bpt,
        max_pending_cycles=spec["max_pending_cycles"])
    eng = serve.ServeEngine(api, params, max_slots=3, max_seq=64,
                            admission=policy,
                            prefill_chunk_tokens=spec["chunk"])
    backend.attach(eng)
    rng = np.random.default_rng(4)
    for n in (10, 40, 12, 9, 14, 6, 11):
        eng.submit(rng.integers(1, cfg.vocab, n), max_new_tokens=8)
    done = eng.run_until_done()
    return {
        "outputs": sorted((r.uid, r.output) for r in done),
        "refused": [r.uid for r in eng.refused],
        "step_log": eng.step_log,
        "stats": dataclasses.asdict(policy.stats),
        "deferred": policy.stats.deferred,
    }


@pytest.mark.parametrize("name", sorted(ADMISSION))
def test_live_admission_matches_reference(served, name):
    spec = ADMISSION[name]
    (jcfg, japi, jp), (tcfg, tapi, tp) = served
    j = _admitted_run(jserve, jcore.dlegion(), (jcfg, japi, jp), spec, {})
    t = _admitted_run(tserve, tcore.dlegion(), (tcfg, tapi, tp), spec,
                      {"device": "cpu"})
    assert t == j
    if spec["max_pending_cycles"] is None:
        assert t["refused"] and t["stats"]["deferred_kv"] > 0
    else:
        assert t["stats"]["deferred_rate"] > 0
