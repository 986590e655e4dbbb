"""Port parity: repro_torch.obs against repro.obs.

The observability layers are integer / pure-Python work over the Legion
cycle model, so every comparison here is exact: ``MetricsRegistry``
snapshots, ``TimelineTracer`` serial and overlapped cycles and its Chrome
JSON (``json.dumps(sort_keys=True)``), ``RooflineTracer.as_dicts()``, the
arrival traces per seed, and ``run_load(...).summary()`` with its metrics
snapshot between the JAX engine + backend and the port's on reduced
BitNet-1.58B in float32 (the greedy tokens of that model agree on these
seeds, as in tests/test_torch_serve.py).
"""
import json

import jax
import numpy as np
import pytest

import repro.configs as jconfigs
import repro.core as jcore
import repro.legion as jlegion
import repro.obs as jobs
import repro.serve as jserve
import repro_torch.configs as tconfigs
import repro_torch.core as tcore
import repro_torch.legion as tlegion
import repro_torch.obs as tobs
import repro_torch.serve as tserve
from repro.core.workloads import decode_attention_workloads as j_attn_wls
from repro.models import build_model as jax_build
from repro.serve.engine import prepare_params as jax_prepare
from repro_torch.convert import params_from_jax
from repro_torch.core.workloads import decode_attention_workloads as t_attn_wls
from repro_torch.models import build_model
from repro_torch.serve.engine import prepare_params

JAX = dict(configs=jconfigs, core=jcore, legion=jlegion, obs=jobs,
           serve=jserve, attn_wls=j_attn_wls, kw={})
PORT = dict(configs=tconfigs, core=tcore, legion=tlegion, obs=tobs,
            serve=tserve, attn_wls=t_attn_wls, kw={"device": "cpu"})
ZOO_ARCHS = ("bitnet-1.58b", "granite-moe-1b-a400m", "zamba2-7b")


@pytest.fixture(scope="module")
def models():
    """Reduced BitNet-1.58B in float32 on both sides, the same weights."""
    jcfg = jconfigs.reduced(jconfigs.get_config("bitnet-1.58b")).replace(
        dtype="float32")
    tcfg = tconfigs.reduced(tconfigs.get_config("bitnet-1.58b")).replace(
        dtype="float32")
    japi, tapi = jax_build(jcfg), build_model(tcfg, device="cpu")
    jp = japi.init(jax.random.PRNGKey(0))
    tp = prepare_params(params_from_jax(jax.tree.map(np.asarray, jp),
                                        device="cpu"))
    return {id(JAX): (jcfg, japi, jax_prepare(jp)),
            id(PORT): (tcfg, tapi, tp)}


# --------------------------------------------------------------------------- #
# MetricsRegistry
# --------------------------------------------------------------------------- #

def _feed(obs, script):
    """Run ``script`` against a fresh registry; returns (snapshot, errors)."""
    reg = obs.MetricsRegistry()
    errors = []
    for call in script:
        try:
            call(reg)
        except (ValueError, KeyError) as exc:
            errors.append((type(exc).__name__, str(exc)))
    return reg.snapshot(), errors


SCRIPT = [
    lambda r: r.counter("steps").inc(),
    lambda r: r.counter("steps").inc(4),
    lambda r: r.counter("runs", labels=("stage",)).inc(stage="qkv"),
    lambda r: r.counter("runs", labels=("stage",)).inc(3, stage="mlp"),
    lambda r: r.gauge("occupancy").set(0.75),
    lambda r: r.gauge("occupancy").set(0.5),
    lambda r: r.histogram("ttft", buckets=(1, 10, 100)).observe(5),
    lambda r: r.histogram("ttft").observe(50),
    lambda r: r.histogram("ttft").observe(500),
    lambda r: r.histogram("batch", labels=("phase",)).observe(3,
                                                               phase="d"),
    # misuse: each raises the same error in both packages
    lambda r: r.counter("steps").inc(-1),
    lambda r: r.gauge("steps"),
    lambda r: r.counter("runs", labels=("other",)),
    lambda r: r.counter("runs", labels=("stage",)).inc(bogus=1),
    lambda r: r.gauge("never").value(),
]


def test_metrics_registry_snapshots_equal():
    jsnap, jerr = _feed(jobs, SCRIPT)
    tsnap, terr = _feed(tobs, SCRIPT)
    assert json.dumps(tsnap, sort_keys=True) == json.dumps(jsnap,
                                                           sort_keys=True)
    assert terr == jerr and len(terr) == 5


# --------------------------------------------------------------------------- #
# TimelineTracer + RooflineTracer on the same Programs
# --------------------------------------------------------------------------- #

def _traced(pkg, build_program):
    """Run the programs ``build_program(pkg)`` on a pipelined Machine with
    both tracers; returns every number the comparison needs."""
    legion, obs = pkg["legion"], pkg["obs"]
    accel = pkg["core"].dlegion()
    timeline = obs.TimelineTracer(accel)
    roof = obs.RooflineTracer(accel)
    machine = legion.Machine(accel, backend=legion.PipelinedExecutor(),
                             instruments=[timeline, roof], **pkg["kw"])
    programs = build_program(pkg)
    reports = [machine.run(p, validate=False) for p in programs]
    return {
        "serial": [timeline.serial_cycles(i) for i in range(len(programs))],
        "overlapped": [timeline.overlapped_cycles(i)
                       for i in range(len(programs))],
        # a lone workload's RunReport has one placement: serial == total
        "report_serial": [getattr(r, "serial_cycles", r.total_cycles)
                          for r in reports],
        "report_total": [r.total_cycles for r in reports],
        "complete": [tl.complete for tl in timeline.programs],
        "page_fetches": sum(c.page_fetches for tl in timeline.programs
                            for c in tl.cells.values()),
        "chrome": json.dumps(timeline.to_chrome(), sort_keys=True),
        "roofline": roof.as_dicts(),
    }


def _zoo(arch):
    def build(pkg):
        cfg = pkg["configs"].reduced(pkg["configs"].get_config(arch))
        return [pkg["legion"].lower(pkg["legion"].zoo_spec(cfg))]
    return build


def _serve_step(models, **step):
    def build(pkg):
        cfg, _api, params = models[id(pkg)]
        backend = pkg["serve"].LegionServeBackend(
            pkg["core"].dlegion(), cfg, params, **pkg["kw"])
        if "chunks" in step:
            return [backend.step_program_mixed(step["chunks"],
                                               step["contexts"])]
        return [backend.step_program(step["m"], step["contexts"],
                                     explicit_layers=2)]
    return build


PROGRAMS = {
    **{f"zoo-{a}": (lambda models, a=a: _zoo(a)) for a in ZOO_ARCHS},
    "serve-two-layer": lambda models: _serve_step(models, m=2,
                                                  contexts=(8, 12)),
    "serve-mixed": lambda models: _serve_step(
        models, chunks=[(6, 6), (4, 10)], contexts=(8, 12)),
    # paged decode attention, each workload run as its own Program
    "paged-attention": lambda models: lambda pkg: pkg["attn_wls"](
        heads=16, kv_heads=4, head_dim=128, context=23, page_tokens=8),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_tracers_match_reference(models, name):
    build = PROGRAMS[name](models)
    j, t = _traced(JAX, build), _traced(PORT, build)
    assert all(t["complete"])
    # the tracer reproduces the run's own report, in the port as in JAX
    assert t["serial"] == t["report_serial"]
    assert t["overlapped"] == t["report_total"]
    assert (t["page_fetches"] > 0) == (name == "paged-attention")
    assert t == j


def test_timeline_export_round_trips(tmp_path):
    accel = tcore.dlegion()
    tracer = tobs.TimelineTracer(accel)
    tlegion.Machine(accel, instruments=[tracer], device="cpu").run(
        t_attn_wls(heads=4, kv_heads=2, head_dim=32, context=9)[0])
    doc = tracer.export(tmp_path / "trace.json")
    assert json.loads((tmp_path / "trace.json").read_text()) == doc


# --------------------------------------------------------------------------- #
# Arrival traces
# --------------------------------------------------------------------------- #

TRACES = {
    "poisson": lambda obs, seed: obs.poisson_trace(
        25, mean_interarrival_cycles=1e4, seed=seed),
    "lognormal": lambda obs, seed: obs.lognormal_trace(
        25, mean_interarrival_cycles=1e4, mean_prompt=48, mean_output=8,
        max_prompt=128, max_output=12, quantum=16, seed=seed),
    "bursty": lambda obs, seed: obs.bursty_trace(
        25, burst_size=4, burst_gap_cycles=300.0, seed=seed),
}


@pytest.mark.parametrize("kind", sorted(TRACES))
@pytest.mark.parametrize("seed", [0, 2, 7])
def test_traces_equal_per_seed(kind, seed):
    j = TRACES[kind](jobs, seed)
    t = TRACES[kind](tobs, seed)
    assert [(a.time, a.prompt_len, a.max_new_tokens) for a in t] == \
        [(a.time, a.prompt_len, a.max_new_tokens) for a in j]


def test_trace_validation_errors_match():
    for kw in ({"n": 0}, {"n": 4, "sigma": 0.0}, {"n": 4, "quantum": 0},
               {"n": 4, "max_prompt": 2, "quantum": 4}):
        msgs = []
        for obs in (jobs, tobs):
            with pytest.raises(ValueError) as exc:
                obs.lognormal_trace(mean_interarrival_cycles=1.0, **kw)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]


# --------------------------------------------------------------------------- #
# run_load: the JAX engine + backend against the port's
# --------------------------------------------------------------------------- #

LOADS = {
    "poisson-inflight": dict(
        engine=dict(max_slots=4, max_seq=64, prefill_chunk_tokens=8),
        trace=lambda obs: obs.poisson_trace(
            10, mean_interarrival_cycles=5000.0, seed=1),
        backend={}),
    "lognormal-tight-paged": dict(
        engine=dict(max_slots=4, max_seq=64),
        paged=dict(total_pages=8, page_tokens=8),
        trace=lambda obs: obs.lognormal_trace(
            12, mean_interarrival_cycles=200.0, seed=3),
        backend=dict(page_tokens=8)),
}


def _load(pkg, models, spec):
    cfg, api, params = models[id(pkg)]
    serve = pkg["serve"]
    reg = pkg["obs"].MetricsRegistry()
    paged = (serve.PagedKVCache(**spec["paged"]) if "paged" in spec
             else None)
    eng = serve.ServeEngine(api, params, metrics=reg, paged_kv=paged,
                            **spec["engine"])
    backend = serve.LegionServeBackend(
        pkg["core"].dlegion(), cfg, params, metrics=reg, **spec["backend"],
        **pkg["kw"]).attach(eng)
    report = pkg["obs"].run_load(eng, backend, spec["trace"](pkg["obs"]),
                                 metrics=reg,
                                 slo=pkg["obs"].SLO(ttft_cycles=1e6))
    return {
        "summary": report.summary(freq_hz=pkg["core"].dlegion().freq_hz),
        "occupancy": report.occupancy,
        "records": [(r.uid, r.first_token, r.finish, r.decode_tokens,
                     r.preempted, r.truncated) for r in report.records],
        "outputs": sorted((r.uid, r.output) for r in eng.finished),
        "step_log": eng.step_log,
        "metrics": json.dumps(reg.snapshot(), sort_keys=True),
        "backend": backend.summary(),
    }


@pytest.mark.parametrize("name", sorted(LOADS))
def test_run_load_matches_reference(models, name):
    spec = LOADS[name]
    j, t = _load(JAX, models, spec), _load(PORT, models, spec)
    assert t["summary"]["completed"] == t["summary"]["requests"]
    if "paged" in spec:
        assert t["summary"]["preempted"] > 0
    for key in ("outputs", "step_log", "records", "occupancy", "summary",
                "backend", "metrics"):
        assert t[key] == j[key], key
