"""Port parity: repro_torch's Legion runtime against repro.legion.

The same workloads, plans and operands go through both Machines; outputs
must be bit-exact, TrafficTotals / CycleBreakdown equal, and the recorded
instrument event streams equal call for call, across W1.58 / W4 / W8
+-ZTB at window and at kernel granularity (+ZTB at kernel granularity is
the block-sparse kernel's path; the reference multiplies it in float32,
the port in int8 -> int32, equal while every sum stays below 2^24).
The copied framework-free modules (core planning and simulation) are held
to the same identity.
"""
import dataclasses
from importlib import import_module
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core as jcore
import repro.core.config as jconfig
import repro.core.workloads as jwl
import repro.legion as jlegion
import repro_torch.core as tcore
import repro_torch.core.config as tconfig
import repro_torch.core.workloads as twl
import repro_torch.legion as tlegion


class Recorder:
    """Records every instrument event as plain values."""

    def __init__(self):
        self.events = []

    def __getattr__(self, hook):
        if not hook.startswith("on_"):
            raise AttributeError(hook)

        def record(*args, **kwargs):
            self.events.append((hook, _plain(args), _plain(kwargs)))
        return record


def _plain(v):
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return tuple(_plain(x) for x in v)
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, (int, float, str, type(None), np.integer, np.floating)):
        return v
    if hasattr(v, "stage") and hasattr(v, "assignments"):   # StagePlan
        return ("plan", v.stage, len(v.assignments))
    if hasattr(v, "weight_bits") and hasattr(v, "backend"):  # ModeSpec
        return ("mode", v.name, v.backend)
    return type(v).__name__                  # program / exec context


def _cfg(mod, legions=2, cores=4, d=8):
    return mod.AcceleratorConfig(
        name=f"t-{legions}L{cores}C{d}D", dataflow=mod.Dataflow.ADIP,
        units=legions, cores=cores, d=d, pipeline=4, adaptive=True,
        packed_weights=True,
    )


def _asdict(obj):
    return dataclasses.asdict(obj) if obj is not None else None


def _run_both(make_cfg, wl_kwargs, *, granularity="window", ztb=False,
              seed=0, plan_run=False, **machine_kw):
    """Run one workload through both Machines with recorders attached."""
    reports, recs = [], []
    for core_mod, wl_mod, legion in ((jconfig, jwl, jlegion),
                                     (tconfig, twl, tlegion)):
        cfg = make_cfg(core_mod)
        wl = wl_mod.GEMMWorkload(**wl_kwargs)
        rec = Recorder()
        kw = dict(machine_kw, granularity=granularity, instruments=[rec])
        if legion is tlegion:
            kw["device"] = "cpu"
        machine = legion.Machine(cfg, **kw)
        if plan_run:
            sched = import_module(core_mod.__name__.replace("config",
                                                            "scheduler"))
            plan = sched.plan_stage(cfg, wl)
            x, w = legion.synthesize_operands(
                wl, seed=seed, ztb_sparsity=0.5 if ztb else 0.0,
                k_window=plan.assignments[0].k_window)
            rep = machine.run(plan, x, w, ztb=True if ztb else None)
        else:
            rep = machine.run(wl, seed=seed,
                              ztb_sparsity=0.5 if ztb else 0.0)
        reports.append(rep)
        recs.append(rec)
    j, t = reports
    assert t.outputs.dtype == j.outputs.dtype
    np.testing.assert_array_equal(t.outputs, j.outputs)
    assert t.mode.name == j.mode.name and t.mode.backend == j.mode.backend
    assert _asdict(t.trace.totals) == _asdict(j.trace.totals)
    assert _asdict(t.cycles.stage_breakdown()[t.plan.stage]) == \
        _asdict(j.cycles.stage_breakdown()[j.plan.stage])
    assert t.total_cycles == j.total_cycles > 0
    assert _asdict(t.ztb_stats) == _asdict(j.ztb_stats)
    for vt, vj in zip(t.validations, j.validations):
        assert vt.ok == vj.ok and str(vt) == str(vj)
    assert len(recs[1].events) == len(recs[0].events) > 0
    for et, ej in zip(recs[1].events, recs[0].events):
        assert et == ej
    return j, t


# Shapes of tests/test_legion_runtime.py (dlegion(): 8 Legions x 8 x 16x16)
RUNTIME_CASES = {
    "w8_attn": dict(stage=jwl.ATTN_SCORE, m=32, k=128, n=128, weight_bits=8,
                    count=4, kv_group=2, mapping=jwl.N_PARTITION),
    "w2_qkv": dict(stage=jwl.QKV_PROJ, m=32, k=256, n=128, weight_bits=2,
                   count=8, shared_input=True, mapping=jwl.HEAD_PER_UNIT),
    "w4_qkv": dict(stage=jwl.QKV_PROJ, m=16, k=256, n=128, weight_bits=4,
                   count=4, shared_input=True, mapping=jwl.HEAD_PER_UNIT),
    "w2_out_ragged": dict(stage=jwl.OUT_PROJ, m=16, k=200, n=96,
                          weight_bits=2, count=1, mapping=jwl.N_PARTITION),
}


def _dlegion(mod):
    return mod.dlegion()


@pytest.mark.parametrize("case", sorted(RUNTIME_CASES))
@pytest.mark.parametrize("ztb", [False, True])
def test_runtime_cases_window_granularity(case, ztb):
    kw = dict(RUNTIME_CASES[case])
    if ztb and kw["weight_bits"] == 8:
        kw = dict(kw, weight_bits=2)       # ZTB prunes quantized weights
    _run_both(_dlegion, kw, ztb=ztb)


@pytest.mark.parametrize("case", sorted(RUNTIME_CASES))
def test_runtime_cases_kernel_granularity(case):
    _run_both(_dlegion, RUNTIME_CASES[case], granularity="kernel")


MODE_MATRIX = [(bits, ztb) for bits in (2, 4, 8) for ztb in (False, True)]


@pytest.mark.parametrize("bits,ztb", MODE_MATRIX)
@pytest.mark.parametrize("case", range(2))
def test_property_mode_matrix(bits, ztb, case):
    """tests/test_legion_properties.py's seeded geometry sweep."""
    rng = np.random.default_rng(1000 * case + 10 * bits + ztb)
    m = int(rng.integers(1, 49))
    k = int(rng.integers(1, 321))
    n = int(rng.integers(1, 161))
    count = int(rng.integers(1, 7))
    legions = int(rng.choice([1, 2, 8]))
    cores, d = [(1, 8), (2, 8), (4, 8), (8, 16)][int(rng.integers(4))]
    banks = int(rng.integers(1, 9))
    mapping = jwl.HEAD_PER_UNIT if rng.integers(2) else jwl.N_PARTITION
    shared = bool(rng.integers(2))
    stage = jwl.QKV_PROJ if mapping == jwl.HEAD_PER_UNIT else jwl.ATTN_SCORE
    wl = dict(stage=stage, m=m, k=k, n=n, weight_bits=bits, count=count,
              shared_input=shared, mapping=mapping)
    make = lambda mod: _cfg(mod, legions, int(cores), int(d))   # noqa: E731
    _run_both(make, wl, ztb=ztb, seed=case, plan_run=True,
              accumulators=banks)
    _run_both(make, wl, ztb=ztb, seed=case, plan_run=True,
              granularity="kernel")


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_core_emulation_and_banks(bits):
    wl = dict(stage=jwl.QKV_PROJ, m=5, k=96, n=40, weight_bits=bits,
              count=2, shared_input=True, mapping=jwl.HEAD_PER_UNIT)
    make = lambda mod: _cfg(mod, 2, 2, 8)   # noqa: E731
    _run_both(make, wl, emulate_cores=True, accumulators=3)


@pytest.mark.parametrize("case", sorted(RUNTIME_CASES))
def test_runtime_cases_kernel_granularity_ztb(case):
    kw = dict(RUNTIME_CASES[case])
    if kw["weight_bits"] == 8:
        kw = dict(kw, weight_bits=2)       # ZTB prunes quantized weights
    j, t = _run_both(_dlegion, kw, granularity="kernel", ztb=True)
    assert t.mode.backend == "block_sparse" and t.ztb_stats is not None


def test_kernel_granularity_ztb_matches_pallas_interpret():
    """tests/test_legion_runtime.py's whole-slice Pallas case: the JAX
    Machine runs the block-sparse Pallas kernel in interpret mode."""
    outs = []
    for wl_mod, core, legion in ((jwl, jcore, jlegion),
                                 (twl, tcore, tlegion)):
        wl = wl_mod.GEMMWorkload(stage=wl_mod.OUT_PROJ, m=128, k=256,
                                 n=1024, weight_bits=2, count=1,
                                 mapping=wl_mod.N_PARTITION)
        kw = (dict(kernel_backend="pallas") if legion is jlegion
              else dict(device="cpu"))
        rep = legion.Machine(core.dlegion(), granularity="kernel",
                             **kw).run(wl, ztb_sparsity=0.5)
        assert rep.mode.backend == "block_sparse" and rep.ok
        outs.append(rep)
    np.testing.assert_array_equal(outs[1].outputs, outs[0].outputs)
    assert _asdict(outs[1].trace.totals) == _asdict(outs[0].trace.totals)


def test_kernel_granularity_ztb_ignores_caller_books():
    """The reference's kernel-granularity +ZTB numerics take the block mask
    from w's own zeros, not from caller-supplied books; at window
    granularity the books gate the product."""
    outs = {}
    for core_mod, wl_mod, legion in ((jconfig, jwl, jlegion),
                                     (tconfig, twl, tlegion)):
        cfg = _cfg(core_mod, 2, 2, 8)
        wl = wl_mod.GEMMWorkload(stage=wl_mod.OUT_PROJ, m=6, k=64, n=32,
                                 weight_bits=2, count=1,
                                 mapping=wl_mod.N_PARTITION)
        sched = import_module(core_mod.__name__.replace("config",
                                                        "scheduler"))
        sparsity = import_module(core_mod.__name__.replace("config",
                                                           "sparsity"))
        plan = sched.plan_stage(cfg, wl)
        x, w = legion.synthesize_operands(wl, seed=2)
        book = sparsity.ztb_from_weight(w[0], block_k=cfg.d, block_n=16,
                                        window=cfg.cores)
        book = dataclasses.replace(book, tile_nonzero=book.tile_nonzero & (
            np.arange(book.tile_nonzero.shape[0]) % 2 == 0)[:, None, None])
        for gran in ("window", "kernel"):
            kw = {"device": "cpu"} if legion is tlegion else {}
            outs[legion.__name__, gran] = legion.Machine(
                cfg, granularity=gran, **kw).run(plan, x, w,
                                                 ztb=[book]).outputs
    dense = x[0].astype(np.int64) @ w[0].astype(np.int64)
    for pkg in ("repro.legion", "repro_torch.legion"):
        np.testing.assert_array_equal(outs[pkg, "kernel"][0], dense)
        assert not np.array_equal(outs[pkg, "window"][0], dense)
        np.testing.assert_array_equal(outs[pkg, "window"],
                                      outs["repro.legion", "window"])


def test_kernel_backend_must_match_device():
    with pytest.raises(ValueError):
        tlegion.Machine(tcore.dlegion(), kernel_backend="cuda", device="cpu")
    with pytest.raises(ValueError):
        tlegion.Machine(tcore.dlegion(), kernel_backend="pallas",
                        device="cpu")


def test_cross_validate_matches_reference():
    wls = [jwl.GEMMWorkload(**kw, layers=3)
           for kw in RUNTIME_CASES.values()]
    jt, jc = jlegion.Machine(jcore.dlegion(legions=8)).cross_validate(wls)
    twls = [twl.GEMMWorkload(**dataclasses.asdict(w)) for w in wls]
    tt, tc = tlegion.Machine(tcore.dlegion(legions=8),
                             device="cpu").cross_validate(twls)
    assert [str(v) for v in tt] == [str(v) for v in jt]
    assert [str(v) for v in tc] == [str(v) for v in jc]
    assert all(v.ok for v in tt + tc)


def test_program_serve_step_matches_reference():
    """A lowered serve step (projections + attention graph) through both
    Machines: every stage's outputs bit-exact and equal to the NumPy
    reference execution."""
    progs = []
    for wl_mod, legion in ((jwl, jlegion), (twl, tlegion)):
        ops = []
        for stage, k, n, count, mapping in (
                (wl_mod.QKV_PROJ, 64, 16, 12, wl_mod.HEAD_PER_UNIT),
                (wl_mod.OUT_PROJ, 64, 64, 1, wl_mod.N_PARTITION),
                (wl_mod.MLP_UP, 64, 96, 2, wl_mod.N_PARTITION),
                (wl_mod.MLP_DOWN, 96, 64, 1, wl_mod.N_PARTITION)):
            wl = wl_mod.GEMMWorkload(stage=stage, m=1, k=k, n=n,
                                     weight_bits=2, count=count,
                                     shared_input=count > 1, mapping=mapping)
            ops.append((wl, np.random.default_rng(count + n).integers(
                -1, 2, size=(count, k, n)).astype(np.int8)))
        progs.append((legion, ops))
    outs = []
    for legion, ops in progs:
        ops = [SimpleNamespace(workload=w, weights=wt) for w, wt in ops]
        program = legion.lower_serve_step(ops, m=3, contexts=(3,), heads=4,
                                          kv_heads=4, head_dim=16, layers=2,
                                          seed=1)
        kw = {"device": "cpu"} if legion is tlegion else {}
        rep = legion.Machine(_dlegion(jconfig if legion is jlegion
                                      else tconfig), **kw).run(program)
        ref = legion.reference_outputs(program)
        for name, out in rep.outputs.items():
            np.testing.assert_array_equal(out, ref[name])
        outs.append(rep.outputs)
    assert outs[0].keys() == outs[1].keys()
    for name in outs[0]:
        np.testing.assert_array_equal(outs[1][name], outs[0][name])


@pytest.mark.parametrize("legions", [1, 8, 32])
@pytest.mark.parametrize("ztb", [None, 0.5])
def test_core_copies_plan_and_simulate_identically(legions, ztb):
    for spec in ("bitnet_1_58b", "bitnet_1_58b_kv"):
        jw = jwl.attention_workloads(getattr(jwl, spec)(seq_len=128))
        tw = twl.attention_workloads(getattr(twl, spec)(seq_len=128))
        jcfg, tcfg = jcore.dlegion(legions=legions), tcore.dlegion(
            legions=legions)
        jstats = tstats = None
        if ztb:
            kw = dict(fully_sparse_fraction=ztb, zero_tile_fraction=ztb,
                      num_windows=10, num_tiles=80)
            jstats, tstats = jcore.ZTBStats(**kw), tcore.ZTBStats(**kw)
        jr = jcore.simulate(jcfg, jw, ztb=jstats)
        tr = tcore.simulate(tcfg, tw, ztb=tstats)
        assert str(_asdict(tr)) == str(_asdict(jr))
        from repro.core.scheduler import plan_stage as jplan
        from repro_torch.core.scheduler import plan_stage as tplan
        for a, b in zip(jw, tw):
            assert str(_asdict(tplan(tcfg, b))) == str(_asdict(jplan(jcfg,
                                                                     a)))


@pytest.fixture
def grouped_calls(monkeypatch):
    """Spy on the grouped bitlinear entry point (bits, items per call); a
    per-assignment whole-slice call fails the test."""
    import repro_torch.kernels.bitlinear.ops as bl_ops
    import repro_torch.legion.machine as tmachine

    calls = []
    real = bl_ops.grouped_tile_gemm

    def spy(x, w, out, slices, *, bits, backend="auto"):
        calls.append((bits, len(slices)))
        return real(x, w, out, slices, bits=bits, backend=backend)

    def per_assignment(*_args, **_kwargs):
        raise AssertionError("an integer stage launched per assignment")

    monkeypatch.setattr(bl_ops, "grouped_tile_gemm", spy)
    monkeypatch.setattr(tmachine, "_kernel_call", per_assignment)
    return calls


@pytest.mark.parametrize("case", sorted(RUNTIME_CASES))
def test_kernel_granularity_launches_once_per_stage(case, grouped_calls):
    _j, t = _run_both(_dlegion, RUNTIME_CASES[case], granularity="kernel")
    assert grouped_calls == [(RUNTIME_CASES[case]["weight_bits"],
                              len(t.plan.assignments))]


def test_program_serve_step_at_kernel_granularity(grouped_calls):
    """A lowered serve step through both Machines at kernel granularity:
    one grouped call per integer stage, outputs bit-exact to the JAX
    Machine and to the NumPy reference execution, tallies equal."""
    reports = []
    for wl_mod, core, legion in ((jwl, jcore, jlegion),
                                 (twl, tcore, tlegion)):
        ops = []
        for stage, k, n, count, mapping in (
                (wl_mod.QKV_PROJ, 64, 16, 12, wl_mod.HEAD_PER_UNIT),
                (wl_mod.OUT_PROJ, 64, 64, 1, wl_mod.N_PARTITION),
                (wl_mod.MLP_UP, 64, 96, 2, wl_mod.N_PARTITION),
                (wl_mod.MLP_DOWN, 96, 64, 1, wl_mod.N_PARTITION)):
            wl = wl_mod.GEMMWorkload(stage=stage, m=1, k=k, n=n,
                                     weight_bits=2, count=count,
                                     shared_input=count > 1, mapping=mapping)
            ops.append(SimpleNamespace(
                workload=wl, weights=np.random.default_rng(count + n)
                .integers(-1, 2, size=(count, k, n)).astype(np.int8)))
        program = legion.lower_serve_step(ops, m=2, contexts=(3, 5),
                                          heads=4, kv_heads=2, head_dim=16,
                                          seed=1)
        kw = {"device": "cpu"} if legion is tlegion else {}
        if legion is tlegion:
            grouped_calls.clear()
        rep = legion.Machine(core.dlegion(), granularity="kernel",
                             **kw).run(program)
        ref = legion.reference_outputs(program)
        for name, out in rep.outputs.items():
            np.testing.assert_array_equal(out, ref[name])
        reports.append((program, rep))
    (jprog, jrep), (tprog, trep) = reports
    assert len(grouped_calls) == len(tprog) == len(jprog)
    assert sorted(bits for bits, _ in grouped_calls) == \
        [2] * 4 + [8] * (len(tprog) - 4)
    assert jrep.outputs.keys() == trep.outputs.keys()
    for name in jrep.outputs:
        np.testing.assert_array_equal(trep.outputs[name], jrep.outputs[name])
    for name, sr in trep.stage_reports.items():
        assert _asdict(sr.trace.totals) == \
            _asdict(jrep.stage_reports[name].trace.totals)
    assert trep.total_cycles == jrep.total_cycles
