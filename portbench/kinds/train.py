"""Training cells: the program's train step (``build_train_step`` of the
configuration's model, AdamW) on the traffic's batches.

One run: the weights made from the seed (``reference/<family>.py``'s
leaves, the program's tree layout) are handed to one train state; the
step drives it through the first ``SETUP_STEPS`` steps, on batches that
all differ, and their readings are kept (``compare``); the same state goes
on into the window, which runs steps on new batches for ``seconds`` and
ends at a synchronise.  With ``trace`` two profiled spans of
``TRACE_STEPS`` steps follow inside the window (``portbench.trace``): the
card's activity alone, then with the host's ops; the steps before them
give the step time.  Once the window has closed and the program's state
is freed, the reference follows the first steps from the same weights
and batches, and the readings are judged against the cell's limits; a
window step whose loss is not finite fails the run too.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, List, Optional

import torch

from portbench import compare, gen
from portbench import reference as refs
from portbench.reference import common

SETUP_STEPS = 3
# the CUDA sources of the training path, built together where not built yet
KERNELS = ("flash_attention", "flash_attention_bwd", "ssd", "ssd_bwd")
TRACE_STEPS = 2


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Program:
    """The program under test: one train state and the step that drives
    it, built once.  ``fault`` plants one of ``portbench.faults`` (never
    in a benchmark run)."""

    def __init__(self, spec: Dict, opt: Dict, seed: int, device,
                 fault: Optional[str] = None):
        from repro_torch.configs.base import ModelConfig
        from repro_torch.models import build_model
        from repro_torch.train import AdamW, TrainState, build_train_step

        self.seed = seed
        self.device = torch.device(device)
        api = build_model(ModelConfig(**spec), device=device)
        self.opt = AdamW(**opt)
        self.leaves = refs.load(spec["family"]).leaves(spec)
        params = common.build_tree(self.leaves, seed, self.device)
        self.state = TrainState(params, self.opt.init(params))
        build = lambda a: build_train_step(a, self.opt)  # noqa: E731
        if fault is None:
            self.step = build(api)
        else:
            from portbench.faults import plant

            self.step = plant(fault, api, build)

    def first_steps(self, batches, n: int = SETUP_STEPS):
        """Steps 1 .. n, each on a new batch: (readings, batches)."""
        kept, losses = [], []
        for i in range(n):
            t = time.perf_counter()
            batch = batches.next()
            kept.append(batch)
            self.state, m = self.step(self.state, batch)
            losses.append(m["loss"])
            if i == 0:
                gnorm = float(m["grad_norm"])
                clip = min(1.0, self.opt.clip_norm / (gnorm + 1e-9))
                per = (1 - self.opt.b1) * clip
                grad = common.slice_norms(self.state.opt.mu, self.leaves,
                                          lambda t, leaf: t / per)
            _sync(self.device)
            print(f"setup step {i + 1}: {time.perf_counter() - t:.2f} s",
                  file=sys.stderr)
        change = compare.change_norms(self.state.params, self.leaves,
                                      self.seed, self.device)
        return {"losses": [float(x) for x in losses], "grad": grad,
                "change": change}, kept


def reference_readings(spec: Dict, opt: Dict, seed: int, batches: List,
                       device, mode: str = "float32") -> Dict:
    """The reference's readings of the first steps from the same weights
    and batches, in ``mode`` (``common.Precision``)."""
    common.configure_matmul()
    fam = refs.load(spec["family"])
    leaves = fam.leaves(spec)
    r = common.Precision(mode)
    units = fam.units(spec, r)
    params = common.build_tree(leaves, seed, device)
    mu, nu = common.zeros_like_tree(params), common.zeros_like_tree(params)
    losses, grad = [], None
    for i, batch in enumerate(batches):
        loss, grads = common.loss_and_grads(units, params, batch, r)
        losses.append(float(loss))
        if i == 0:
            grad = common.slice_norms(grads, leaves)
        common.adamw_step(params, grads, mu, nu, i + 1, opt, leaves)
        del grads
    del mu, nu
    change = compare.change_norms(params, leaves, seed, device)
    return {"losses": losses, "grad": grad, "change": change}


def window(prog: Program, batches, seconds: float, traced: bool):
    """Steps on new batches until ``seconds`` have passed, then a
    synchronise; with ``traced`` the two profiled spans follow, inside the
    window.  Returns (steps, wall seconds, losses, trace summary or None,
    seconds a step before the spans)."""
    from torch.profiler import record_function

    from portbench import trace as tr

    device = prog.device
    losses = []

    def one():
        with record_function("pb.batch"):
            batch = batches.next()
        with record_function("pb.step"):
            prog.state, m = prog.step(prog.state, batch)
        losses.append(m["loss"])

    sync, cuda = (lambda: _sync(device)), device.type == "cuda"
    steps = 0
    sync()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while not steps or time.perf_counter() < deadline:
        one()
        steps += 1
    sync()
    step_s = (time.perf_counter() - t0) / steps
    print(f"window: {steps} steps, {step_s:.4f} s a step", file=sys.stderr)
    summary = None
    if traced:
        summary = tr.record(one, TRACE_STEPS, sync, cuda, host=False)
        ops = tr.record(one, TRACE_STEPS, sync, cuda, host=True)
        summary.update(ops=ops["ops"], device_ops=ops["device_ops"])
        steps += 2 * (TRACE_STEPS + 1)
    sync()
    return steps, time.perf_counter() - t0, losses, summary, step_s


def run(ctx: Dict) -> Dict:
    spec, traffic = ctx["config"]["as_run"], ctx["traffic"]
    opt, seed, device = ctx["config"]["train"], ctx["seed"], ctx["device"]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        from repro_torch.kernels import build

        build.build(KERNELS)
    prog = Program(spec, opt, seed, device)
    _sync(device)
    built = time.time() - ctx["started"]
    batches = gen.TokenBatches(traffic, spec["vocab"], seed, prog.device)
    readings, kept = prog.first_steps(batches)
    _sync(device)
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        # the trace's marker kernel (``trace.MARKER``) loaded before the
        # window
        torch.cuda._sleep(1)
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - ctx["started"]
    print(f"setup: state built {built:.2f} s, {SETUP_STEPS} steps and "
          f"their readings {setup_s - built:.2f} s", file=sys.stderr)

    steps, wall, losses, summary, step_s = window(
        prog, batches, ctx["seconds"], ctx["trace"])
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    tokens = traffic["batch"] * traffic["seq"]
    del prog, losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref = reference_readings(spec, opt, seed, kept, device)
    print(f"reference: {time.perf_counter() - t:.1f} s", file=sys.stderr)
    found = compare.gaps(readings, ref)
    for name, g in found.items():
        judged = "" if name in ctx["limits"] else ", not compared"
        print(f"{name}: {g['value']!r} at {g['where']}{judged}",
              file=sys.stderr)
    correct, checks = compare.judge(found, ctx["limits"])

    out = {"attempted": steps, "failed": failed,
           "correct": correct and not failed,
           "checks": checks,
           "device": {"memory_peak_bytes": max(setup_peak, window_peak)},
           "readings": {"program": readings["losses"],
                        "reference": ref["losses"]}}
    if not ctx["trace"]:
        out["metrics"] = {
            "train_tokens_per_s": steps * tokens / wall,
            "train_peak_gb": window_peak / 1e9,
            "setup_s": setup_s,
        }
        return out
    mctx = {"spec": spec, "traffic": traffic, "step_s": step_s,
            "elt": torch.tensor([], dtype=getattr(
                torch, spec["dtype"])).element_size()}
    metrics = {}
    for name in ctx["per_layer"]:
        from portbench.metrics import load

        value = load(name).read(summary, mctx)
        if value is not None and math.isfinite(value):
            metrics[name] = value
    out["metrics"] = metrics
    out["device"].update(busy_s=summary["busy_s"],
                         window_s=summary["window_s"])
    out["breakdown"] = {"device_ops": summary["device_ops"],
                        "idle_gaps": summary["idle_gaps"]}
    out["trace"] = summary
    return out
