"""Quickstart on the port: the D-Legion stack in fourteen sections.

    python -m repro_torch.examples.quickstart [--device cpu]

1. Reproduce the paper's headline comparison with the cycle simulator.
2. Run the packed-ternary bitlinear kernel (``csrc/bitlinear.cu``).
3. Build a ZTB from a block-sparse weight and run the block-sparse kernel
   (``csrc/block_sparse.cu``).
4. One QAT train step + one serving step of a tiny BitNet model.
5. Execute one attention stage through a `legion.Machine` session and
   cross-check its measured traffic against the simulator.
6. Drive one serving decode step's projection GEMMs through the serve-path
   Legion backend — per-token bytes AND cycles, cross-validated.
7. The Machine session API: one-liner runs, custom instruments, and the
   sharded executor backend (the Legion axis over the port's devices,
   bit-exact).
8. The Program graph API: a full attention block as one dependency graph,
   bit-exact against a pure NumPy reference, with the PipelinedExecutor
   overlapping rounds of independent stages.
9. Serve pipelining: a two-explicit-layer program, a merged two-slot
   decode batch, and the engine-view overlapped tokens/sec feeding the
   KV-cache budget.
10. Observability: a `TimelineTracer` rebuilds the cycle timeline of a
    pipelined program and exports a Chrome/Perfetto trace; a
    `MetricsRegistry` snapshots the machine + serve metric families.
11. In-flight batching: chunked prefill merged with the decode batch into
    one Program per step, intake gated by `LiveAdmission`.
12. Paged KV cache: a page pool squeezed to force preemption mid-decode.
13. Finite bandwidth: the stall knee, a cross-validated sweep, per-stage
    roofline points.
14. Workload zoo: MoE expert skip and the Mamba-2 SSD scan through
    `legion.lower(spec)`.

On the card (the default) sections 2 and 3 launch the CUDA kernels and
the models and the Legion runtime run there; ``--device cpu`` runs the
plain versions.  Each section is a function that returns its numbers;
``main`` prints them as the JAX package's ``examples/quickstart.py`` does.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import (
    adip_64, attention_workloads, bitnet_1_58b, compare, dip_64, dlegion,
    simulate, ws_64,
)
from repro_torch.core.sparsity import prune_block_structured, ztb_from_weight
from repro_torch.core.workloads import bitnet_1_58b_kv
from repro_torch.data import synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.kernels.bitlinear.ops import bitlinear_matmul
from repro_torch.kernels.block_sparse.ops import ztb_matmul
from repro_torch.legion import (
    Instrument, Machine, PipelinedExecutor, ShardedExecutor,
    find_stall_knee, hbm_bytes_per_cycle, lower, lower_attention,
    moe_stage_names, reference_outputs, sweep_bandwidth,
)
from repro_torch.models import build_model
from repro_torch.models.mamba2 import ssd_lowering_spec
from repro_torch.models.moe import moe_lowering_spec
from repro_torch.obs import MetricsRegistry, RooflineTracer, TimelineTracer
from repro_torch.quant.packing import pack_2bit_kmajor
from repro_torch.serve import (
    LegionServeBackend, LiveAdmission, PagedKVCache, ServeEngine,
)
from repro_torch.serve.engine import prepare_params
from repro_torch.serve.kv_cache import plan as kv_plan
from repro_torch.train import AdamW, build_train_step, init_train_state

RULE = "=" * 70


def attention_spec():
    """One layer of BitNet-1.58B-KV at 128 tokens (sections 5, 7, 8, 13)."""
    return dataclasses.replace(bitnet_1_58b_kv(seq_len=128), layers=1)


def tiny_bitnet():
    return reduced(get_config("bitnet-1.58b"))


# --------------------------------------------------------------------------- #
# Sections
# --------------------------------------------------------------------------- #

def simulator():
    """1. The cycle simulator's reports for WS / DiP / ADiP / D-Legion on
    BitNet-1.58B's attention, and D-Legion's ratios against ADiP."""
    wl = attention_workloads(bitnet_1_58b())
    reports = [simulate(c, wl) for c in (ws_64(), dip_64(), adip_64(),
                                         dlegion())]
    return {"reports": reports,
            "ratios": compare(reports, "ADiP-64x64")["D-Legion-8L"]}


def bitlinear(device, rng):
    """2. A ternary weight packed 4-per-byte times int8 activations
    through the bitlinear kernel, equal to the int32 GEMM."""
    w = rng.integers(-1, 2, size=(512, 256)).astype(np.int8)
    x = rng.integers(-128, 128, size=(128, 512)).astype(np.int8)
    wp = pack_2bit_kmajor(torch.from_numpy(w).to(device))
    out = bitlinear_matmul(torch.from_numpy(x).to(device), wp).cpu().numpy()
    if not (out == x.astype(np.int32) @ w.astype(np.int32)).all():
        raise AssertionError("bitlinear kernel != int32 GEMM")
    return {"x_shape": x.shape, "packed": wp.cpu().numpy(), "out": out,
            "weight_bytes": w.size * 2}


def ztb(device, rng):
    """3. A block-pruned float weight's ZTB, and the block-sparse kernel
    skipping its zero blocks (within the JAX package's 1e-4 / 1e-3)."""
    wf = rng.standard_normal((512, 384)).astype(np.float32)
    wf = prune_block_structured(wf, block_k=128, block_n=128, sparsity=0.5)
    book = ztb_from_weight(wf, block_k=128, block_n=128, window=4)
    nz = book.tile_nonzero.reshape(-1, 384 // 128)[: 512 // 128]
    xf = rng.standard_normal((128, 512)).astype(np.float32)
    out = ztb_matmul(torch.from_numpy(xf).to(device),
                     torch.from_numpy(wf).to(device), nz).cpu().numpy()
    np.testing.assert_allclose(out, xf @ wf, rtol=1e-4, atol=1e-3)
    return {"stats": book.stats(), "out": out, "want": xf @ wf}


def qat_step(device, state=None, cfg=None):
    """4a. One QAT train step of reduced BitNet-1.58B (``cfg`` if given;
    a state from seed 0 unless given); returns the loss and the new
    state."""
    cfg = cfg or tiny_bitnet()
    api = build_model(cfg, device=device)
    opt = AdamW(lr=1e-3)
    if state is None:
        state = init_train_state(api, opt, 0)
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             synthetic_batch(cfg, batch=2, seq=64, step=0).items()}
    state, metrics = build_train_step(api, opt)(state, batch)
    return {"loss": float(metrics["loss"]), "state": state,
            "tokens": batch["tokens"]}


def serve_decode(device, params, tokens, cfg=None):
    """4b. On the served weights (the trained ones ternary-quantized
    once), a prefill of ``tokens``' first row and one decode step: the
    sampled tokens."""
    cfg = cfg or tiny_bitnet()
    api = build_model(cfg, device=device)
    cache = api.init_cache(1, 80)
    logits, cache = api.prefill(params, {"tokens": tokens[:1]}, cache)
    tok = int(torch.argmax(logits[0, -1]))
    logits, cache = api.decode(params, torch.tensor([tok], device=device),
                               cache, 64)
    return {"token": tok, "next_token": int(torch.argmax(logits[0, -1]))}


def machine_stage(device):
    """5. The score stage of one attention layer through a Machine session:
    outputs, measured traffic and the simulator's."""
    score = attention_workloads(attention_spec())[1]
    cfg_leg = dlegion()
    res = Machine(cfg_leg, device=device).run(score)
    if not res.ok:
        raise AssertionError("machine run failed its validation")
    sim = simulate(cfg_leg, [score]).stages[score.stage]
    return {"score": score, "res": res, "totals": res.trace.totals,
            "sim": sim}


def serve_backend(device, cfg, params):
    """6. One decode step's GEMMs through the serve-path Legion backend,
    cross-validated against simulate()."""
    backend = LegionServeBackend(dlegion(), cfg, params, device=device)
    tally = backend.step_tally(1, (16,))
    tvals, cvals = backend.cross_validate(m=1, contexts=(16,))
    if not all(v.ok for v in tvals + cvals):
        raise AssertionError("serve backend cross-validation failed")
    return {"backend": backend, "tally": tally,
            "worst": max(v.rel_err for v in cvals)}


class PassCounter(Instrument):
    """Custom instrument: count executed vs ZTB-skipped passes."""

    def __init__(self):
        self.executed = 0
        self.skipped = 0

    def on_pass(self, **event):
        self.executed += 1

    def on_window_skip(self, **event):
        self.skipped += 1


def sessions(device, score):
    """7. A session-lifetime instrument, and the ShardedExecutor (the
    Legion axis over the port's devices: every card, or ``device``)
    bit-exact against the in-process run."""
    cfg_leg = dlegion()
    probe = PassCounter()
    rep = Machine(cfg_leg, instruments=[probe], device=device).run(score)
    devices = None if device.type == "cuda" else [device]
    sharded = Machine(cfg_leg, backend=ShardedExecutor(devices=devices),
                      device=device)
    rep_sh = sharded.run(score)
    if not (np.array_equal(rep.outputs, rep_sh.outputs)
            and rep_sh.trace.totals == rep.trace.totals):
        raise AssertionError("ShardedExecutor differs from in-process")
    return {"probe": probe, "rep": rep,
            "devices_used": sharded.backend.devices_used}


def program_graph(device):
    """8. The whole attention block as one Program, pipelined, against
    the NumPy reference; the chain and the split q/k/v graphs."""
    spec = attention_spec()
    block = lower_attention(spec)
    piped = Machine(dlegion(), backend=PipelinedExecutor(), device=device)
    prep = piped.run(block)
    ref = reference_outputs(block)
    if not (prep.ok and all(np.array_equal(prep.outputs[k], ref[k])
                            for k in ref)):
        raise AssertionError("program outputs != NumPy reference")
    pp2 = piped.run(lower_attention(spec, split_qkv=True)).pipeline
    return {"block": block, "chain": prep.pipeline, "split": pp2,
            "piped": piped}


def serve_pipelining(backend, piped, cfg):
    """9. A two-explicit-layer step program, a merged two-slot decode
    batch, and the overlapped cycles feeding the KV-cache budget."""
    two_layer = backend.step_program(1, (16,), explicit_layers=2)
    rep9 = piped.run(two_layer)
    if not rep9.ok:
        raise AssertionError("two-layer program failed its validation")
    merged = backend.step_program(2, (12, 20))
    pp9 = piped.run(merged).pipeline
    serial9, overlapped9 = backend.step_pipeline(2, (12, 20))
    budget = kv_plan(cfg, batch=2, max_seq=64, hbm_bytes_per_chip=16e9,
                     chips=1, cycles_per_token=overlapped9 / 2,
                     freq_hz=dlegion().freq_hz,
                     serial_cycles_per_token=serial9 / 2)
    return {"two_layer": two_layer, "merged": merged, "pipeline": pp9,
            "budget": budget}


def observability(device, merged):
    """10. A TimelineTracer and a MetricsRegistry on a pipelined Machine
    running the merged decode batch; the Chrome trace goes to a
    temporary directory."""
    cfg_leg = dlegion()
    tracer = TimelineTracer(cfg_leg)
    reg = MetricsRegistry()
    rep = Machine(cfg_leg, backend=PipelinedExecutor(),
                  instruments=[tracer], metrics=reg,
                  device=device).run(merged)
    if (tracer.serial_cycles() != rep.serial_cycles
            or tracer.overlapped_cycles() != rep.total_cycles):
        raise AssertionError("timeline cycles != the counter's")
    path = os.path.join(tempfile.mkdtemp(), "trace.json")
    tracer.export(path)
    return {"tracer": tracer, "registry": reg, "path": path,
            "snapshot": reg.snapshot()}


def inflight(device, cfg, params):
    """11. In-flight batching under LiveAdmission against the legacy
    engine (bit-exact outputs)."""
    api = build_model(cfg, device=device)
    backend = LegionServeBackend(dlegion(), cfg, params, device=device)
    eng = ServeEngine(api, params, max_slots=3, max_seq=64,
                      prefill_chunk_tokens=8,
                      admission=LiveAdmission(backend,
                                              hbm_bytes_per_chip=8 << 30))
    backend.attach(eng)
    prompts = [np.arange(1, 4 + 3 * i) for i in range(4)]
    reqs = [eng.submit(p, max_new_tokens=3 + i % 2)
            for i, p in enumerate(prompts)]
    done = eng.run_until_done()
    legacy = ServeEngine(api, params, max_slots=3, max_seq=64)
    legacy_reqs = [legacy.submit(p, max_new_tokens=3 + i % 2)
                   for i, p in enumerate(prompts)]
    legacy.run_until_done()
    outputs = [r.output for r in reqs]
    if outputs != [r.output for r in legacy_reqs]:
        raise AssertionError("in-flight outputs != legacy engine's")
    return {"outputs": outputs, "done": done, "engine": eng,
            "summary": backend.summary(),
            "chunks": sum(1 for e in eng.step_log
                          if e["phase"] == "prefill_chunk")}


def paged(device, cfg, params):
    """12. Five requests through 8 pages of 4 tokens, with preemptions,
    against the contiguous engine (bit-exact outputs)."""
    api = build_model(cfg, device=device)
    prompts = [np.arange(1, 5 + 2 * i) for i in range(5)]
    pool = PagedKVCache(total_pages=8, page_tokens=4)
    backend = LegionServeBackend(dlegion(), cfg, params, page_tokens=4,
                                 device=device)
    eng = ServeEngine(api, params, max_slots=3, max_seq=32, paged_kv=pool)
    backend.attach(eng)
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run_until_done()
    ref = ServeEngine(api, params, max_slots=3, max_seq=32)
    ref_reqs = [ref.submit(p, max_new_tokens=6) for p in prompts]
    ref.run_until_done()
    outputs = [r.output for r in reqs]
    if outputs != [r.output for r in ref_reqs]:
        raise AssertionError("paged outputs != contiguous engine's")
    stats = pool.allocator.stats()
    preempts = sum(1 for e in eng.step_log if e["phase"] == "preempt")
    if not preempts or stats.pinned_pages:
        raise AssertionError(f"{preempts} preemptions, {stats}")
    return {"outputs": outputs, "pool": pool, "stats": stats,
            "preemptions": preempts, "summary": backend.summary()}


def bandwidth(device):
    """13. The stall knee of the attention block, a cross-validated sweep
    around it, and per-stage roofline points below it."""
    cfg_leg = dlegion()
    wl = attention_workloads(attention_spec())
    knee = find_stall_knee(cfg_leg, wl)
    sweep = sweep_bandwidth(cfg_leg, wl, [knee / 4, knee * 2],
                            cross_validate=True, device=device)
    if not (sweep.worst_rel_err == 0.0 and sweep.points[0].stalled
            and not sweep.points[1].stalled):
        raise AssertionError(f"bandwidth sweep {sweep}")
    mach = Machine(cfg_leg, mem_bw_bytes_per_cycle=knee / 2, device=device)
    tracer = mach.add_instrument(RooflineTracer())
    for w in wl:
        mach.run(w, check_outputs=False, validate=False)
    rows = tracer.rows()
    if any(p.efficiency > 1.0 for p in rows):
        raise AssertionError("roofline efficiency above 1")
    return {"knee": knee, "budget": hbm_bytes_per_cycle(cfg_leg),
            "sweep": sweep, "rows": rows}


def zoo(device):
    """14. A granite-MoE FFN block with its unchosen experts as skipped
    windows (the traffic saved is exactly their weight bytes), and
    Mamba-2's SSD scan lowered in 2 chunks; both bit-exact."""
    cfg_leg = dlegion()
    moe_cfg = reduced(get_config("granite-moe-1b-a400m"))
    spec = moe_lowering_spec(moe_cfg, tokens=16)
    prog = lower(spec)
    rep = Machine(cfg_leg, device=device).run(prog)
    ref = reference_outputs(prog)
    if not (rep.ok and all(np.array_equal(rep.outputs[n], ref[n])
                           for n in ref)):
        raise AssertionError("MoE program != NumPy reference")
    chosen, skipped = spec.routing()
    dense = Machine(cfg_leg, device=device).run(lower(dataclasses.replace(
        spec, top_k=spec.n_experts, chosen=None)))

    def weight_bytes(r):
        return sum(r[n].traffic.weight_bytes for n in r.outputs)

    skipped_bytes = sum(dense[n].traffic.weight_bytes
                        for e in skipped for n in moe_stage_names(e))
    if weight_bytes(rep) != weight_bytes(dense) - skipped_bytes:
        raise AssertionError("expert skip saved other than its bytes")
    ssm_cfg = reduced(get_config("mamba2-130m"))
    prog_b = lower(ssd_lowering_spec(ssm_cfg, chunks=2))
    rep_b = Machine(cfg_leg, device=device).run(prog_b)
    ref_b = reference_outputs(prog_b)
    if not (rep_b.ok and all(np.array_equal(rep_b.outputs[k], ref_b[k])
                             for k in ref_b)):
        raise AssertionError("SSD program != NumPy reference")
    return {"spec": spec, "chosen": chosen, "moe_bytes": weight_bytes(rep),
            "dense_bytes": weight_bytes(dense), "ssm_cfg": ssm_cfg,
            "ssd_stages": len(prog_b)}


# --------------------------------------------------------------------------- #
# The script
# --------------------------------------------------------------------------- #

def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    device = resolve_device(ap.parse_args(argv).device)
    cfg_leg = dlegion()

    print(RULE)
    print("1. Cycle simulator — D-Legion vs WS / DiP / ADiP "
          "(paper Figs. 7-10)")
    s1 = simulator()
    for r in s1["reports"]:
        print(f"   {r.arch:14s} latency={r.total_seconds*1e3:8.2f} ms"
              f"  throughput={r.total_tops:6.2f} TOPS"
              f"  memory={r.total_mem_gb:6.2f} GB  "
              f"psum={r.total_psum_gb:6.1f} GB")
    ratios = s1["ratios"]
    print(f"   D-Legion vs ADiP: {ratios['latency_x']:.2f}x latency, "
          f"{ratios['mem_x']:.2f}x memory, {ratios['psum_x']:.2f}x psum")

    print(RULE)
    print("2. bitlinear kernel — ternary weights packed 4-per-byte")
    rng = np.random.default_rng(0)
    s2 = bitlinear(device, rng)
    wp = s2["packed"]
    print(f"   x[{s2['x_shape']}] @ packed w[{wp.shape} uint8] == int32 "
          f"GEMM: OK (weight bytes: {s2['weight_bytes']}B bf16 -> "
          f"{wp.size}B packed, {s2['weight_bytes'] / wp.size:.0f}x less)")

    print(RULE)
    print("3. ZTB block-sparse kernel — fully-sparse windows never touched")
    stats = ztb(device, rng)["stats"]
    print(f"   sparsity={stats.zero_tile_fraction:.2f}, "
          f"fully-sparse windows={stats.fully_sparse_fraction:.2f}, "
          f"allclose OK")

    print(RULE)
    print("4. Tiny BitNet: one QAT step + one serving decode")
    s4 = qat_step(device)
    print(f"   QAT train step: loss={s4['loss']:.3f}")
    cfg = tiny_bitnet()
    params = prepare_params(s4["state"].params)
    s4b = serve_decode(device, params, s4["tokens"])
    print(f"   served (ternary weights): first sampled token="
          f"{s4b['token']}")

    print(RULE)
    print("5. Legion Machine — one attention stage executed through the "
          "plan")
    s5 = machine_stage(device)
    score, res, tot, sim = s5["score"], s5["res"], s5["totals"], s5["sim"]
    print(f"   {score.stage}: {score.count} heads on {cfg_leg.units} "
          f"Legions, mode={res.mode.name}, outputs={res.outputs.shape} == "
          f"x @ w: OK")
    print(f"   measured  weight={tot.weight_bytes / 1e6:6.3f} MB  "
          f"act={tot.act_bytes / 1e6:6.3f} MB  "
          f"psum={tot.psum_bytes / 1e6:6.3f} MB")
    print(f"   analytic  weight={sim.weight_bytes / 1e6:6.3f} MB  "
          f"act={sim.act_bytes / 1e6:6.3f} MB  "
          f"psum={sim.psum_bytes / 1e6:6.3f} MB")
    print(f"   NoC multicast deduped {res.trace.multicast_hits} tile "
          f"transfers")

    print(RULE)
    print("6. Serve-path Legion backend — one decode step through the "
          "Machine")
    s6 = serve_backend(device, cfg, params)
    tally = s6["tally"]
    print(f"   {tally.gemms} GEMMs lowered to one Program and executed: "
          f"wq/wk/wv/wo + w1/w2/w3 projections AND the act-to-act "
          f"attention stages\n   (KV cache as stationary operands, K/N = "
          f"context 16)")
    print(f"   per decode token: {tally.cycles} cycles "
          f"({tally.seconds(cfg_leg.freq_hz) * 1e6:.2f} us @ 1 GHz), "
          f"weight={tally.weight_bytes / 1e3:.1f} KB, "
          f"act={tally.act_bytes / 1e3:.1f} KB")
    print(f"   measured vs simulate() on the same workloads: worst cycle "
          f"error {s6['worst'] * 100:.2f}% — serve path cross-validated")

    print(RULE)
    print("7. Machine session API — instruments + executor backends")
    s7 = sessions(device, score)
    rep = s7["rep"]
    print(f"   instrument saw {s7['probe'].executed} executed passes; "
          f"report merges weight={rep.traffic.weight_bytes / 1e6:.3f} MB, "
          f"{rep.total_cycles} cycles, validation ok={rep.ok}")
    print(f"   ShardedExecutor on {s7['devices_used']} device(s): outputs "
          f"bit-exact, traffic/cycles identical")

    print(RULE)
    print("8. Program graph API — whole attention block, pipelined")
    s8 = program_graph(device)
    block, pp, pp2 = s8["block"], s8["chain"], s8["split"]
    print(f"   {len(block)} stages ({' -> '.join(block.names)})")
    print("   act-to-act stages executed as real GEMMs (K/V stationary, "
          "GQA multicast); all outputs == NumPy reference")
    print(f"   chain graph: overlapped == serial == {pp.serial_cycles} "
          f"cycles (dependency chains cannot overlap)")
    print(f"   split q/k/v graph: serial={pp2.serial_cycles} -> "
          f"overlapped={pp2.overlapped_cycles} cycles "
          f"({pp2.speedup:.3f}x, {pp2.hidden_cycles} fill/pipeline cycles "
          f"hidden under independent streams)")

    print(RULE)
    print("9. Serve pipelining — multi-layer programs + merged decode "
          "batches")
    s9 = serve_pipelining(s6["backend"], s8["piped"], cfg)
    two_layer, pp9, budget = s9["two_layer"], s9["pipeline"], s9["budget"]
    print(f"   two-layer step program: {len(two_layer)} stages, "
          f"qkv_proj@1 depends on {two_layer['qkv_proj@1'].deps} — "
          f"explicit cross-layer dep, 0% xval per stage")
    print(f"   merged 2-slot decode batch: serial={pp9.serial_cycles} -> "
          f"overlapped={pp9.overlapped_cycles} cycles "
          f"({pp9.speedup:.3f}x — slots hide each other's fill/pipeline)")
    print(f"   engine view: {budget.tokens_per_sec:,.0f} tokens/s/slot "
          f"overlapped (pipelining x{budget.pipelining_speedup:.3f} vs "
          f"serial) -> latency-aware KV-cache admission")

    print(RULE)
    print("10. Observability — timeline trace export + metrics registry")
    s10 = observability(device, s9["merged"])
    tracer, reg, snap = s10["tracer"], s10["registry"], s10["snapshot"]
    tl = tracer.programs[-1]
    print(f"   traced {len(tl.cells)} round slices across "
          f"{len(tl.stage_order)} stages: serial makespan "
          f"{tracer.serial_cycles()} == counter, overlapped "
          f"{tracer.overlapped_cycles()} == pipeline report")
    print(f"   Chrome trace written to {s10['path']} — open in "
          f"ui.perfetto.dev (pid 0 = serial placement, pid 1 = overlapped)")
    print(f"   metrics: {len(snap)} families; "
          f"machine_cycles={snap['machine_cycles']['series']['']:.0f}, "
          f"machine_passes={snap['machine_passes']['series']['']:.0f}, "
          f"pipeline speedup p50="
          f"{reg.get('machine_pipeline_speedup').percentile(50):.3f}x")

    print(RULE)
    print("11. In-flight batching — chunked prefill merged with decode + "
          "live admission")
    s11 = inflight(device, cfg, params)
    eng, summ, done = s11["engine"], s11["summary"], s11["done"]
    print(f"   {len(done)} requests, {s11['chunks']} prefill chunks merged "
          f"into {summ['engine_steps']} engine steps (one Program each)")
    print(f"   engine view incl. prefill: "
          f"overlapped {summ['overlapped_cycles_per_step']:.0f} <= "
          f"serial {summ['serial_cycles_per_step']:.0f} cycles/step "
          f"(x{summ['pipeline_speedup']:.3f})")
    print(f"   live admission on the measured budget: "
          f"{eng.admission.stats.admitted} admitted, "
          f"{eng.admission.stats.deferred} deferred, "
          f"{eng.admission.stats.refused} refused; window truncations "
          f"flagged: {sum(r.truncated for r in done)}")

    print(RULE)
    print("12. Paged KV cache — block allocator, forced preemption, "
          "page-priced traffic")
    s12 = paged(device, cfg, params)
    st, summ = s12["stats"], s12["summary"]
    print(f"   {len(s12['outputs'])} requests through {st.total_pages} "
          f"pages of {s12['pool'].page_tokens} tokens: "
          f"{s12['preemptions']} preemptions ({st.evictions} evictions), "
          f"outputs bit-exact vs contiguous")
    print(f"   page-priced traffic: {summ['page_fetches']:.0f} fetches, "
          f"{summ['page_fetch_bytes'] / 1024:.1f} KiB, last-page waste "
          f"{summ['page_waste_frac']:.1%} of page bytes "
          f"(serial cycles unchanged by construction)")

    print(RULE)
    print("13. Finite bandwidth — the stall knee, a cross-validated sweep, "
          "and per-stage roofline points")
    s13 = bandwidth(device)
    knee, sweep = s13["knee"], s13["sweep"]
    print(f"   stall knee at {knee:.1f} B/cycle "
          f"({s13['budget'] / knee:.0f}x headroom under the paper budget); "
          f"quarter-knee run stalls {sweep.points[0].stall_frac:.0%} "
          f"of its cycles, cross-validated at 0% error")
    for p in s13["rows"]:
        bound = "memory" if p.memory_bound else "compute"
        print(f"   {p.stage:<10} {p.mode:<6} {p.arithmetic_intensity:7.1f} "
              f"ops/B  stall {p.stall_frac:5.1%}  eff {p.efficiency:.2f} "
              f"({bound}-bound, {p.legions_used} Legions)")

    print(RULE)
    print("14. Workload zoo — MoE expert skip and the Mamba-2 SSD scan "
          "through the unified legion.lower(spec)")
    s14 = zoo(device)
    spec = s14["spec"]
    print(f"   MoE {spec.n_experts} experts, top-{spec.top_k} "
          f"(chose {list(s14['chosen'])}): {s14['moe_bytes'] / 1024:.1f} "
          f"KiB weights vs {s14['dense_bytes'] / 1024:.1f} KiB dense — "
          f"skip saves {s14['dense_bytes'] / s14['moe_bytes']:.2f}x, "
          f"bit-exact incl. skipped experts")
    print(f"   SSD scan {s14['ssm_cfg'].ssm_heads} heads x 2 chunks of "
          f"{s14['ssm_cfg'].ssd_chunk}: {s14['ssd_stages']} stages, "
          f"bit-exact, state carried as a cross-chunk stationary Ref")
    print("quickstart complete.")


if __name__ == "__main__":
    main()
