"""Port parity: a seeded serving run through both engines, each with a
LegionServeBackend attached, on reduced BitNet-1.58B in float32.

Greedy tokens, the engine's step_log, and every backend tally must be
identical: the Legion tallies are integer/NumPy work (bit-exact), and the
greedy argmax of the float32 logits agrees on this seed.
"""
import dataclasses

import jax
import numpy as np
import pytest

import repro_torch.configs as tconfigs
import repro_torch.core as tcore
from repro.configs import get_config, reduced
from repro.core import dlegion
from repro.models import build_model as jax_build
from repro.serve import LegionServeBackend as JaxBackend
from repro.serve import ServeEngine as JaxEngine
from repro.serve.engine import prepare_params as jax_prepare
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.serve import LegionServeBackend, ServeEngine
from repro_torch.serve.engine import prepare_params


def _serve(engine_cls, backend_cls, api, params, cfg, accel, **backend_kw):
    eng = engine_cls(api, params, max_slots=2, max_seq=64)
    backend = backend_cls(accel, cfg, params, **backend_kw).attach(eng)
    rng = np.random.default_rng(0)
    for _ in range(4):
        eng.submit(rng.integers(1, cfg.vocab, size=rng.integers(4, 12)),
                   max_new_tokens=5)
    done = eng.run_until_done()
    return eng, backend, done


@pytest.fixture(scope="module")
def served():
    jcfg = reduced(get_config("bitnet-1.58b")).replace(dtype="float32")
    tcfg = tconfigs.reduced(tconfigs.get_config("bitnet-1.58b")).replace(
        dtype="float32")
    japi, tapi = jax_build(jcfg), build_model(tcfg, device="cpu")
    jp = japi.init(jax.random.PRNGKey(0))
    tp = prepare_params(params_from_jax(jax.tree.map(np.asarray, jp),
                                        device="cpu"))
    jp = jax_prepare(jp)
    jax_run = _serve(JaxEngine, JaxBackend, japi, jp, jcfg, dlegion())
    port_run = _serve(ServeEngine, LegionServeBackend, tapi, tp, tcfg,
                      tcore.dlegion(), device="cpu")
    return jax_run, port_run, tp


def test_greedy_outputs_identical(served):
    (_, _, jdone), (_, _, tdone), _ = served
    assert len(tdone) == len(jdone) == 4
    assert [(r.uid, r.output, r.truncated) for r in tdone] == \
        [(r.uid, r.output, r.truncated) for r in jdone]


def test_step_log_identical(served):
    (jeng, _, _), (teng, _, _), _ = served
    assert teng.step_log == jeng.step_log
    assert teng.decode_batch_sizes == jeng.decode_batch_sizes


def test_backend_tallies_identical(served):
    (_, jb, _), (_, tb, _), _ = served
    assert tb.summary() == jb.summary()
    assert sorted(tb.per_request) == sorted(jb.per_request)
    for uid, tally in jb.per_request.items():
        assert dataclasses.asdict(tb.per_request[uid]) == \
            dataclasses.asdict(tally)


def test_cross_validate_decode_step(served):
    (_, jb, _), (_, tb, _), _ = served
    jt, jc = jb.cross_validate(m=1, contexts=(16,))
    tt, tc = tb.cross_validate(m=1, contexts=(16,))
    assert all(v.ok for v in tt + tc)
    assert [str(v) for v in tt + tc] == [str(v) for v in jt + jc]
    worst = max([e for v in tt for e in v.errors.values()]
                + [v.rel_err for v in tc])
    assert worst == max([e for v in jt for e in v.errors.values()]
                        + [v.rel_err for v in jc])


def test_kernel_and_window_granularity_agree(served):
    """One decode step (m=1, context 16) at both granularities: the same
    stage outputs and the same tallies."""
    _, (_, tb, _), params = served
    kernel, window = (
        LegionServeBackend(tcore.dlegion(), tb.model_cfg, params,
                           device="cpu", granularity=g)
        for g in ("kernel", "window"))
    a = kernel.machine.run(kernel.step_program(1, (16,)), validate=False)
    b = window.machine.run(window.step_program(1, (16,)), validate=False)
    assert a.outputs.keys() == b.outputs.keys()
    for name in a.outputs:
        np.testing.assert_array_equal(a.outputs[name], b.outputs[name])
    assert dataclasses.asdict(kernel.step_tally(1, (16,))) == \
        dataclasses.asdict(window.step_tally(1, (16,)))


def test_engine_rejects_unported_modes():
    """In-flight batching, paged KV and admission are ported
    (tests/test_torch_inflight.py, test_torch_paged_kv.py); what the
    engine still rejects, as the JAX engine does: a chunk budget below 1,
    chunked prefill for a family without it, a page pool that cannot back
    one max_seq window, and an admission verdict it does not know."""
    from repro_torch.serve import PagedKVCache

    tcfg = tconfigs.reduced(tconfigs.get_config("bitnet-1.58b"))
    api = build_model(tcfg, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        ServeEngine(api, {}, prefill_chunk_tokens=0)
    ssm = build_model(tconfigs.reduced(tconfigs.get_config("mamba2-130m")),
                      device="cpu")
    with pytest.raises(ValueError, match="no chunked prefill"):
        ServeEngine(ssm, {}, prefill_chunk_tokens=4)
    with pytest.raises(ValueError, match="cannot back one"):
        ServeEngine(api, {}, max_seq=64,
                    paged_kv=PagedKVCache(total_pages=3, page_tokens=16))

    class Shrug:
        def decide(self, engine, request):
            return "maybe"

    eng = ServeEngine(api, api.init(0), max_seq=32, admission=Shrug())
    eng.submit(np.arange(1, 5), max_new_tokens=2)
    with pytest.raises(ValueError, match="'maybe'"):
        eng.step()
