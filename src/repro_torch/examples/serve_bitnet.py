"""End-to-end serving driver (the paper's kind: inference acceleration):
offline-quantize a BitNet-style model to ternary weights and stream batched
requests through the continuous-batching engine on the card.  With the
Legion backend (on unless ``--no-legion``) every prefill/decode step's
projection GEMMs also execute through the D-Legion runtime, producing
per-request traffic and cycle tallies.

    python -m repro_torch.examples.serve_bitnet --requests 12 --slots 4
    python -m repro_torch.examples.serve_bitnet --full-size --requests 4 \\
        --max-new 8

The KV-cache budget is planned against the card's own memory; on the CPU
(``--device cpu``) pass ``--hbm-bytes``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import dlegion
from repro_torch.device import resolve_device
from repro_torch.legion import ShardedExecutor
from repro_torch.models import build_model
from repro_torch.serve import LegionServeBackend, ServeEngine
from repro_torch.serve.engine import prepare_params
from repro_torch.serve.kv_cache import plan


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="bitnet-1.58b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config")
    ap.add_argument("--no-legion", action="store_true",
                    help="skip the D-Legion serve backend tallies")
    ap.add_argument("--legions", type=int, default=8,
                    help="Legion count for the accelerator model")
    ap.add_argument("--sharded", action="store_true",
                    help="run step GEMMs through the ShardedExecutor (the "
                         "Legion axis over every card, or over --device)")
    ap.add_argument("--hbm-bytes", type=float, default=None,
                    help="memory a chip holds for the KV-cache budget "
                         "(default: the card's total memory)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def serve(args, cfg, params, device, log=print):
    """``args.requests`` random prompts (seed 0) through a ServeEngine on
    ``params`` (served weights), with the Legion backend unless
    ``args.no_legion``; returns the finished requests, the backend's
    summary and per-request tallies, the worst cross-validation error and
    the cache budgets."""
    hbm = args.hbm_bytes
    if hbm is None:
        if device.type != "cuda":
            raise ValueError("--hbm-bytes is needed off the card")
        hbm = torch.cuda.get_device_properties(device).total_memory
    api = build_model(cfg, device=device)
    budget = plan(cfg, batch=args.slots, max_seq=args.max_seq,
                  hbm_bytes_per_chip=hbm, chips=1)
    log(f"arch={cfg.name}  kv-bytes/token={budget.bytes_per_token}  "
        f"cache={budget.total_bytes/1e6:.1f}MB  fits={budget.fits_hbm}")
    eng = ServeEngine(api, params, max_slots=args.slots,
                      max_seq=args.max_seq)

    backend = accel = None
    if not args.no_legion:
        accel = dlegion(legions=args.legions)
        executor = None
        if args.sharded:
            executor = ShardedExecutor(
                devices=None if device.type == "cuda" else [device])
        backend = LegionServeBackend(accel, cfg, params, executor=executor,
                                     device=device).attach(eng)
        log(f"legion backend attached: {accel.name}, every step lowered "
            f"to a Program (projections + act-to-act attention over the "
            f"KV context) through a Machine session "
            f"({backend.machine.backend.name} executor)")

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for _ in range(args.requests):
        prompt = rng.integers(1, cfg.vocab, size=rng.integers(4, 24))
        eng.submit(prompt, max_new_tokens=args.max_new)
    done = eng.run_until_done()
    dt = time.perf_counter() - t0
    tokens = sum(len(r.output) for r in done)
    log(f"served {len(done)} requests / {tokens} tokens in {dt:.2f}s "
        f"({tokens/dt:.1f} tok/s on this host)")
    for r in done[:3]:
        log(f"  req {r.uid}: prompt[{len(r.prompt)}] -> {r.output}")
    out = {"done": done, "seconds": dt, "tokens": tokens, "budget": budget}
    if backend is None:
        return out

    s = backend.summary()
    log(f"D-Legion tallies ({s['prefill_steps']} prefills, "
        f"{s['decode_steps']} decode steps through the runtime):")
    log(f"  per decode token: {s['cycles_per_decode_token']} cycles "
        f"({s['us_per_decode_token']:.3f} us @ 1 GHz)")
    log(f"  total: {s['cycles'] / 1e3:.1f} kcycles, "
        f"weight={s['weight_bytes'] / 1e6:.2f} MB, "
        f"act={s['act_bytes'] / 1e6:.2f} MB, "
        f"psum={s['psum_bytes'] / 1e6:.2f} MB")
    for uid in sorted(backend.per_request)[:3]:
        t = backend.per_request[uid]
        log(f"  req {uid}: prefill[{t.prefill_tokens}] + "
            f"decode[{t.decode_tokens}] -> {t.cycles} cycles, "
            f"{t.mem_bytes / 1e3:.1f} KB moved")
    tv, cv = backend.cross_validate(m=1, contexts=(16,))
    worst = max([e for v in tv for e in v.errors.values()]
                + [v.rel_err for v in cv])
    if not all(v.ok for v in tv + cv):
        raise AssertionError(f"cross-validation failed: worst error "
                             f"{worst}")
    log(f"  cross-validated vs simulate() ({len(tv)} stage families, "
        f"attention included): worst error {worst * 100:.2f}% — OK")

    # latency-aware admission: measured decode cycles -> tokens/sec
    latency = plan(cfg, batch=args.slots, max_seq=args.max_seq,
                   hbm_bytes_per_chip=hbm, chips=1,
                   cycles_per_token=s["cycles_per_decode_token"],
                   freq_hz=accel.freq_hz)
    log(f"  latency-aware cache budget: "
        f"{latency.tokens_per_sec:,.0f} tok/s per slot "
        f"({latency.batch_tokens_per_sec:,.0f} across {args.slots} "
        f"slots), {latency.seconds_to_fill(args.max_seq) * 1e3:.2f} ms "
        f"to fill a {args.max_seq}-token window")
    out.update(summary=s, per_request=dict(backend.per_request),
               worst_error=worst, latency_budget=latency)

    # engine view: each batched decode step as one merged graph through
    # the pipelined schedule (overlapped <= serial, asserted)
    if s["decode_steps"]:
        piped = backend.cache_budget(batch=args.slots, max_seq=args.max_seq,
                                     hbm_bytes_per_chip=hbm, chips=1)
        log(f"  engine view (merged batch graphs, pipelined): "
            f"{s['overlapped_cycles_per_step']:.0f} of "
            f"{s['serial_cycles_per_step']:.0f} cycles/step "
            f"(x{s['pipeline_speedup']:.3f}) -> "
            f"{piped.tokens_per_sec:,.0f} tok/s per slot overlapped")
        out["piped_budget"] = piped
    return out


def main(argv=None):
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = reduced(cfg)
    # offline ternary quantization of seed-0 weights
    params = prepare_params(build_model(cfg, device=device).init(0))
    return serve(args, cfg, params, device)


if __name__ == "__main__":
    main()
