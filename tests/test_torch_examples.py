"""Port parity: the four example drivers (``repro_torch.examples``) on the
CPU against the JAX package's scripts in ``examples/`` and the functions
those call, at the scripts' own sizes (reduced ones where a JAX run would
take minutes).

- ``sparsity_dse`` prints the JAX script's output byte for byte (the JAX
  script runs in a subprocess; it imports no JAX).
- ``quickstart``: each section against the JAX package's functions on the
  same inputs, never the JAX script whole (its Pallas sections run in
  interpret mode; here the JAX side takes its plain references): integers
  equal (simulator reports, traffic bytes, cycles, served tokens, engine
  and admission tallies); floats within the JAX script's tolerances (the
  block-sparse product 1e-4 / 1e-3) or the loss within rel 1e-5.  The
  parameters are the JAX package's, converted (``repro_torch.convert``).
- ``train_bitnet --tiny`` (float32): three steps from the JAX state equal
  the JAX steps' losses within rel 1e-5 (the first only under QAT, whose
  ternary roundings can part after an update), and a run stopped at its
  checkpoint then restarted ends bit-equal to an uninterrupted one.
- ``serve_bitnet`` (reduced, 3 requests of 4 tokens) with the Legion
  backend: the JAX engine's tokens, the backend's summary and per-request
  tallies, equal.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.legion as jlegion
from repro.configs import get_config, reduced
from repro.core.sparsity import prune_block_structured as jax_prune
from repro.core.sparsity import ztb_from_weight as jax_ztb
from repro.data import synthetic_batch
from repro.models import build_model as jax_build
from repro.quant.packing import pack_2bit_kmajor as jax_pack
from repro.serve import LegionServeBackend as JaxBackend
from repro.serve import LiveAdmission as JaxAdmission
from repro.serve import PagedKVCache as JaxPaged
from repro.serve import ServeEngine as JaxEngine
from repro.serve.engine import prepare_params as jax_prepare
from repro.serve.kv_cache import plan as jax_plan
from repro.train import AdamW as JaxAdamW
from repro.train import build_train_step as jax_train_step
from repro.train import cosine_schedule as jax_cosine
from repro.train import init_train_state as jax_init_state
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.examples import (
    quickstart, serve_bitnet, sparsity_dse, train_bitnet,
)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CPU = torch.device("cpu")
F32_BITNET = quickstart.tiny_bitnet().replace(dtype="float32")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------------- #
# sparsity_dse
# --------------------------------------------------------------------------- #

def test_sparsity_dse_prints_the_jax_scripts_output(capsys):
    want = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "sparsity_dse.py")],
        capture_output=True, text=True, check=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))).stdout
    sparsity_dse.main(["--device", "cpu"])
    assert capsys.readouterr().out == want


def test_examples_need_the_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for module in (quickstart, serve_bitnet, train_bitnet, sparsity_dse):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main([])


# --------------------------------------------------------------------------- #
# quickstart, section by section
# --------------------------------------------------------------------------- #

def test_simulator_section_equals_jax():
    got = quickstart.simulator()
    wl = jcore.attention_workloads(jcore.bitnet_1_58b())
    reports = [jcore.simulate(c, wl) for c in (
        jcore.ws_64(), jcore.dip_64(), jcore.adip_64(), jcore.dlegion())]
    for a, b in zip(got["reports"], reports):
        assert (a.arch, a.total_cycles, a.total_seconds, a.total_tops,
                a.total_mem_gb, a.total_psum_gb) == (
            b.arch, b.total_cycles, b.total_seconds, b.total_tops,
            b.total_mem_gb, b.total_psum_gb)
    assert got["ratios"] == jcore.compare(reports, "ADiP-64x64")[
        "D-Legion-8L"]


def test_kernel_sections_equal_jax():
    """Sections 2 and 3 share one generator, as the script's do: the
    packed weight is the JAX packing's, the product the int32 GEMM; the
    ZTB statistics are the JAX package's and the block-sparse product
    within the script's tolerance of x @ w."""
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    s2 = quickstart.bitlinear(CPU, rng)
    w = jrng.integers(-1, 2, size=(512, 256)).astype(np.int8)
    x = jrng.integers(-128, 128, size=(128, 512)).astype(np.int8)
    np.testing.assert_array_equal(s2["packed"],
                                  np.asarray(jax_pack(jnp.asarray(w))))
    np.testing.assert_array_equal(s2["out"],
                                  x.astype(np.int32) @ w.astype(np.int32))
    s3 = quickstart.ztb(CPU, rng)
    wf = jax_prune(jrng.standard_normal((512, 384)).astype(np.float32),
                   block_k=128, block_n=128, sparsity=0.5)
    xf = jrng.standard_normal((128, 512)).astype(np.float32)
    assert dataclasses.asdict(s3["stats"]) == dataclasses.asdict(
        jax_ztb(wf, block_k=128, block_n=128, window=4).stats())
    np.testing.assert_allclose(s3["out"], xf @ wf, rtol=1e-4, atol=1e-3)


@pytest.fixture(scope="module")
def served():
    """Section 4 on the JAX side (reduced BitNet-1.58B in float32 from
    PRNGKey(0), one QAT step, its served weights, a prefill and a decode
    step), and the port's section 4 from the same state.  float32: the
    script's bf16 rounds the two packages' sums apart (1.4e-4 in the
    loss)."""
    cfg = reduced(get_config("bitnet-1.58b")).replace(dtype="float32")
    api = jax_build(cfg)
    opt = JaxAdamW(lr=1e-3)
    state = jax_init_state(api, opt, jax.random.PRNGKey(0))
    port = quickstart.qat_step(CPU, train_state_from_jax(_np(state),
                                                         device="cpu"),
                               cfg=F32_BITNET)
    batch = {k: jnp.asarray(v) for k, v in
             synthetic_batch(cfg, batch=2, seq=64, step=0).items()}
    state, metrics = jax.jit(jax_train_step(api, opt))(state, batch)
    params = jax_prepare(state.params)
    cache = api.init_cache(1, 80)
    logits, cache = api.prefill(params, {"tokens": batch["tokens"][:1]},
                                cache)
    tok = int(jnp.argmax(logits[0, -1]))
    logits, _ = api.decode(params, jnp.array([tok]), cache, jnp.int32(64))
    return {"cfg": cfg, "api": api, "params": params,
            "loss": float(metrics["loss"]), "token": tok,
            "next_token": int(jnp.argmax(logits[0, -1])),
            "port_loss": port["loss"], "tokens": port["tokens"],
            "port_params": params_from_jax(_np(params), device="cpu")}


def test_qat_and_serve_section_equals_jax(served):
    assert served["port_loss"] == pytest.approx(served["loss"], rel=1e-5)
    got = quickstart.serve_decode(CPU, served["port_params"],
                                  served["tokens"], cfg=F32_BITNET)
    assert (got["token"], got["next_token"]) == (served["token"],
                                                 served["next_token"])


def _spec():
    return dataclasses.replace(jcore.workloads.bitnet_1_58b_kv(seq_len=128),
                               layers=1)


@pytest.fixture(scope="module")
def graph():
    """Section 8 (the slowest: the Machine checks every stage's output
    against int64 products on the host)."""
    return quickstart.program_graph(CPU)


def test_machine_sections_equal_jax(graph):
    """Sections 5, 7 (in-process; the port's ShardedExecutor is held to it
    inside the section), 8 and 13 against the JAX Machine's plain runs
    (section 8's pipelines without the JAX run's output checks, which the
    port's section makes)."""
    cfg_leg = jcore.dlegion()
    s5 = quickstart.machine_stage(CPU)
    score = jcore.attention_workloads(_spec())[1]
    res = jlegion.Machine(cfg_leg).run(score)
    assert dataclasses.asdict(s5["totals"]) == dataclasses.asdict(
        res.trace.totals)
    assert s5["res"].trace.multicast_hits == res.trace.multicast_hits
    np.testing.assert_array_equal(s5["res"].outputs, res.outputs)

    s7 = quickstart.sessions(CPU, s5["score"])
    assert s7["rep"].total_cycles == jlegion.Machine(cfg_leg).run(
        score).total_cycles
    assert s7["devices_used"] == 1

    piped = jlegion.Machine(cfg_leg, backend=jlegion.PipelinedExecutor())
    chain, split = (piped.run(jlegion.lower_attention(_spec(), **kw),
                              check_outputs=False, validate=False).pipeline
                    for kw in ({}, {"split_qkv": True}))
    for got, want in ((graph["chain"], chain), (graph["split"], split)):
        assert (got.serial_cycles, got.overlapped_cycles,
                got.hidden_cycles) == (want.serial_cycles,
                                       want.overlapped_cycles,
                                       want.hidden_cycles)

    s13 = quickstart.bandwidth(CPU)
    wl = jcore.attention_workloads(_spec())
    knee = jlegion.find_stall_knee(cfg_leg, wl)
    assert s13["knee"] == knee
    sweep = jlegion.sweep_bandwidth(cfg_leg, wl, [knee / 4, knee * 2],
                                    cross_validate=True)
    assert [p.stall_frac for p in s13["sweep"].points] == [
        p.stall_frac for p in sweep.points]
    from repro.obs import RooflineTracer

    mach = jlegion.Machine(cfg_leg, mem_bw_bytes_per_cycle=knee / 2)
    tracer = mach.add_instrument(RooflineTracer())
    for w in wl:
        mach.run(w, check_outputs=False, validate=False)
    assert [dataclasses.astuple(p) for p in s13["rows"]] == [
        dataclasses.astuple(p) for p in tracer.rows()]


def test_zoo_section_equals_jax():
    from repro.models.mamba2 import ssd_lowering_spec
    from repro.models.moe import moe_lowering_spec

    got = quickstart.zoo(CPU)
    spec = moe_lowering_spec(reduced(get_config("granite-moe-1b-a400m")),
                             tokens=16)
    rep = jlegion.Machine(jcore.dlegion()).run(jlegion.lower(spec))
    assert got["chosen"] == spec.routing()[0]
    assert got["moe_bytes"] == sum(rep[n].traffic.weight_bytes
                                   for n in rep.outputs)
    assert got["ssd_stages"] == len(jlegion.lower(ssd_lowering_spec(
        reduced(get_config("mamba2-130m")), chunks=2)))


def test_serve_sections_equal_jax(served, graph):
    """Sections 6, 9, 10, 11 and 12 on the served weights of section 4:
    the backend's tallies, pipelines and budget, the timeline and metrics,
    and the in-flight and paged engines' tokens and tallies equal the JAX
    package's."""
    cfg, params, tp = served["cfg"], served["params"], served["port_params"]
    cfg_leg = jcore.dlegion()
    s6 = quickstart.serve_backend(CPU, F32_BITNET, tp)
    backend = JaxBackend(cfg_leg, cfg, params)
    assert dataclasses.asdict(s6["tally"]) == dataclasses.asdict(
        backend.step_tally(1, (16,)))

    s9 = quickstart.serve_pipelining(s6["backend"], graph["piped"],
                                     F32_BITNET)
    piped = jlegion.Machine(cfg_leg, backend=jlegion.PipelinedExecutor())
    merged = backend.step_program(2, (12, 20))
    pp = piped.run(merged).pipeline
    assert (s9["pipeline"].serial_cycles,
            s9["pipeline"].overlapped_cycles) == (pp.serial_cycles,
                                                  pp.overlapped_cycles)
    serial, overlapped = backend.step_pipeline(2, (12, 20))
    budget = jax_plan(cfg, batch=2, max_seq=64, hbm_bytes_per_chip=16e9,
                      chips=1, cycles_per_token=overlapped / 2,
                      freq_hz=cfg_leg.freq_hz,
                      serial_cycles_per_token=serial / 2)
    assert dataclasses.asdict(s9["budget"]) == dataclasses.asdict(budget)
    assert len(s9["two_layer"]) == len(backend.step_program(
        1, (16,), explicit_layers=2))

    from repro.obs import MetricsRegistry, TimelineTracer

    s10 = quickstart.observability(CPU, s9["merged"])
    tracer, reg = TimelineTracer(cfg_leg), MetricsRegistry()
    jlegion.Machine(cfg_leg, backend=jlegion.PipelinedExecutor(),
                    instruments=[tracer], metrics=reg).run(merged)
    assert (s10["tracer"].serial_cycles(),
            s10["tracer"].overlapped_cycles()) == (
        tracer.serial_cycles(), tracer.overlapped_cycles())
    assert s10["snapshot"] == reg.snapshot()
    assert os.path.getsize(s10["path"]) > 0

    s11 = quickstart.inflight(CPU, F32_BITNET, tp)
    api = served["api"]
    jb = JaxBackend(cfg_leg, cfg, params)
    eng = JaxEngine(api, params, max_slots=3, max_seq=64,
                    prefill_chunk_tokens=8,
                    admission=JaxAdmission(jb, hbm_bytes_per_chip=8 << 30))
    jb.attach(eng)
    reqs = [eng.submit(np.arange(1, 4 + 3 * i), max_new_tokens=3 + i % 2)
            for i in range(4)]
    eng.run_until_done()
    assert s11["outputs"] == [r.output for r in reqs]
    assert s11["summary"] == jb.summary()
    assert s11["engine"].step_log == eng.step_log
    assert dataclasses.asdict(s11["engine"].admission.stats) == \
        dataclasses.asdict(eng.admission.stats)

    s12 = quickstart.paged(CPU, F32_BITNET, tp)
    pool = JaxPaged(total_pages=8, page_tokens=4)
    jb = JaxBackend(cfg_leg, cfg, params, page_tokens=4)
    eng = JaxEngine(api, params, max_slots=3, max_seq=32, paged_kv=pool)
    jb.attach(eng)
    reqs = [eng.submit(np.arange(1, 5 + 2 * i), max_new_tokens=6)
            for i in range(5)]
    eng.run_until_done()
    assert s12["outputs"] == [r.output for r in reqs]
    assert s12["summary"] == jb.summary()
    assert dataclasses.asdict(s12["stats"]) == dataclasses.asdict(
        pool.allocator.stats())


# --------------------------------------------------------------------------- #
# train_bitnet and serve_bitnet
# --------------------------------------------------------------------------- #

TRAIN_ARGS = ["--tiny", "--batch", "2", "--seq", "32", "--device", "cpu"]


def _train_args(tmp_path, name, steps, every):
    return train_bitnet.parser().parse_args(TRAIN_ARGS + [
        "--steps", str(steps), "--ckpt-every", str(every),
        "--ckpt-dir", str(tmp_path / name)])


def _jax_tiny_losses(cfg, steps):
    """The JAX script's tiny run on ``cfg`` (AdamW on the cosine schedule,
    grad_accum 2) from PRNGKey(0): its starting state and each of
    ``steps`` steps' loss on TRAIN_ARGS' batches."""
    api = jax_build(cfg)
    opt = JaxAdamW(lr=jax_cosine(3e-3, warmup=10, total=steps))
    state = jax_init_state(api, opt, jax.random.PRNGKey(0))
    start, step, losses = _np(state), jax.jit(
        jax_train_step(api, opt, grad_accum=2)), []
    for s in range(steps):
        batch = {k: jnp.asarray(v) for k, v in synthetic_batch(
            cfg, batch=2, seq=32, step=s).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return start, losses


def _jax_model_tiny():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_train_bitnet", os.path.join(ROOT, "examples", "train_bitnet.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script.model_tiny()


@pytest.mark.parametrize("quantization", ["bitnet", "none"])
def test_train_bitnet_tiny_equals_jax(tmp_path, quantization):
    """Three steps of the script's tiny run (in float32, as section 4)
    from the JAX state: each logged loss within rel 1e-5 of the JAX
    step's, where JAX's and the port's ternary weights agree; with the
    script's QAT they do for the first step, and after an update a weight
    whose |w| / mean|w| sits an ulp from a rounding edge can round
    otherwise on each side (moving the loss ~3e-4 here; see
    test_torch_train.py), so only the first step is held there."""
    jcfg = _jax_model_tiny().replace(dtype="float32",
                                     quantization=quantization)
    cfg = train_bitnet.model_tiny().replace(dtype="float32",
                                            quantization=quantization)
    start, want = _jax_tiny_losses(jcfg, 3)
    got = train_bitnet.train(_train_args(tmp_path, "run", 3, 2), CPU,
                             state=train_state_from_jax(start, device="cpu"),
                             log=lambda *a: None, cfg=cfg)["logged"]
    held = 1 if quantization == "bitnet" else 3
    assert [got[s]["loss"] for s in range(1, held + 1)] == pytest.approx(
        want[:held], rel=1e-5)


def test_train_bitnet_restart_resumes_bit_for_bit(tmp_path):
    """The script's tiny run stopped at its step-2 checkpoint and started
    again to step 3 resumes there and ends with the uninterrupted run's
    state, bit for bit."""
    from repro_torch.train.optimizer import tree_leaves

    def run(name, steps):
        return train_bitnet.train(_train_args(tmp_path, name, steps, 2), CPU,
                                  log=lambda *a: None)

    whole = run("whole", 3)
    assert run("cut", 2)["resumed"] == 0
    again = run("cut", 3)
    assert again["resumed"] == 2 and list(again["logged"]) == [3]
    for a, b in zip(tree_leaves(again["runner"].state),
                    tree_leaves(whole["runner"].state)):
        assert torch.equal(a, b)


def test_serve_bitnet_reduced_equals_jax():
    """The script's reduced run (3 requests of 4 new tokens, 4 slots)
    with the Legion backend on the JAX package's served weights: the JAX
    engine's tokens, and the backend's summary and per-request tallies."""
    args = serve_bitnet.parser().parse_args(
        ["--requests", "3", "--max-new", "4", "--device", "cpu",
         "--hbm-bytes", "16e9"])
    cfg = reduced(get_config("bitnet-1.58b"))
    api = jax_build(cfg)
    params = jax_prepare(api.init(jax.random.PRNGKey(0)))
    got = serve_bitnet.serve(args, cfg, params_from_jax(_np(params),
                                                        device="cpu"),
                             CPU, log=lambda *a: None)
    eng = JaxEngine(api, params, max_slots=4, max_seq=256)
    backend = JaxBackend(jcore.dlegion(legions=8), cfg, params).attach(eng)
    rng = np.random.default_rng(0)
    for _ in range(3):
        eng.submit(rng.integers(1, cfg.vocab, size=rng.integers(4, 24)),
                   max_new_tokens=4)
    done = eng.run_until_done()
    assert [r.output for r in got["done"]] == [r.output for r in done]
    assert got["summary"] == backend.summary()
    assert {u: dataclasses.asdict(t) for u, t in
            got["per_request"].items()} == {
        u: dataclasses.asdict(t) for u, t in backend.per_request.items()}
    assert got["worst_error"] == 0.0
