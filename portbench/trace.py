"""Profiled spans of steps, reduced to what the per-layer metrics read.

``record(one_step, steps, sync, cuda, host)`` runs ``steps`` steps under
``torch.profiler`` inside a ``record_function`` span, after one step that
takes the profiler's start (the host synchronises with the card at both
ends of the span), and returns the plain summary below, which ``metrics/*.py``
read and the CPU tests hold as JSON.  Recording the host's ops slows the
host by about half a step, so a training step then waits on the host; the
device's timeline (``window_s``, ``busy_s``, ``kernels``, ``idle_gaps``) is
taken from a span that records the card's activity alone, and the host
ops' attribution (``ops``, ``device_ops``) from a second span:

- ``window_s``: the span's wall; ``busy_s``: the union of its device
  operations' intervals (kernels, copies, fills); ``steps``: steps in it;
- ``kernels``: {kernel function name: [count, device µs]};
- ``ops``: {host op name: [calls, device µs of what it launched]} (a call
  nested in one of its own name counts once);
- ``device_ops``: the ten device operations with the most time, named by
  the host op that launched them and the kernel, [name, seconds];
- ``idle_gaps``: the ten longest idle gaps of the device, named by the
  harness's span and the innermost host op running when each began.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Tuple

SPAN = "pb.span"
LABELS = ("pb.step", "pb.batch")
# ``torch.cuda._sleep``'s kernel: launched at both ends of the measured
# steps, it marks them on the card's timeline in either kind of span
MARKER = "spin_kernel"


def kernel_name(key: str) -> str:
    """The function name in a kernel's key: return type, namespaces,
    template arguments and parameters dropped."""
    head = key.replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", head, maxsplit=1)[0].split()
    return head[-1].split("::")[-1] if head else key


def _union(intervals: List[Tuple[float, float]]):
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def record(one_step: Callable[[], None], steps: int,
           sync: Callable[[], None], cuda: bool, host: bool) -> Dict:
    """``steps + 1`` calls of ``one_step`` profiled; the summary is of
    the last ``steps`` (the first absorbs the profiler's start, whose
    first launches idle the card for a tenth of a second or more): the
    card's activity where ``cuda``, the host's ops where ``host``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = (([ProfilerActivity.CPU] if host or not cuda else [])
                  + ([ProfilerActivity.CUDA] if cuda else []))
    import torch

    mark = (lambda: torch.cuda._sleep(1000)) if cuda else (lambda: None)
    sync()
    with profile(activities=activities) as prof:
        one_step()
        sync()
        with record_function(SPAN):
            mark()
            for _ in range(steps):
                one_step()
            mark()
            sync()
    return summarize(prof.events(), steps)


def _bounds(cpu, dev):
    """The measured steps' start and end: on the card's timeline from the
    end of the first marker kernel to the start of the last (where the
    card ran none, the CPU, the harness's span); on the host's, the
    harness's span where the host's ops were recorded."""
    span = [(e.time_range.start, e.time_range.end) for e in cpu
            if e.name == SPAN]
    marks = sorted((e.time_range.start, e.time_range.end) for e in dev
                   if kernel_name(e.name) == MARKER)
    device = (marks[0][1], marks[-1][0]) if len(marks) >= 2 else span[0]
    return device, (span[0] if span else device)


def summarize(events, steps: int) -> Dict:
    from torch.autograd import DeviceType

    annotation = lambda e: (getattr(e, "is_user_annotation", False)  # noqa
                            or e.name == SPAN or e.name in LABELS)
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    dev = [e for e in events
           if e.device_type != DeviceType.CPU and not annotation(e)]
    (lo, hi), (host_lo, host_hi) = _bounds(cpu, dev)
    dev = [e for e in dev if kernel_name(e.name) != MARKER]
    kernels: Dict[str, List[float]] = {}
    intervals = []
    dev = [e for e in dev if e.time_range.end > lo and e.time_range.start < hi]
    for e in dev:
        a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if b > a:
            intervals.append((a, b))
        k = kernels.setdefault(kernel_name(e.name), [0, 0.0])
        k[0] += 1
        k[1] += e.time_range.elapsed_us()
    ops: Dict[str, List[float]] = {}
    launched: Dict[str, float] = {}
    cpu = [e for e in cpu
           if e.time_range.end > host_lo and e.time_range.start < host_hi]
    for e in cpu:
        if e.cpu_parent is not None and e.cpu_parent.name == e.name:
            continue
        o = ops.setdefault(e.name, [0, 0.0])
        o[0] += 1
        o[1] += e.device_time_total
        for k in e.kernels:
            key = f"{e.name}: {kernel_name(k.name)}"
            launched[key] = launched.get(key, 0.0) + k.duration
    merged = _union(intervals)
    busy = sum(b - a for a, b in merged)
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy / 1e6,
        "steps": steps,
        "kernels": kernels,
        "ops": {k: v for k, v in ops.items() if v[1] > 0 or k in LABELS},
        "device_ops": [[k, v / 1e6] for k, v in sorted(
            launched.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[_doing(cpu, t), g / 1e6] for g, t in gaps],
    }


def _doing(cpu, t: float) -> str:
    """The harness's span and the innermost host op running at ``t``."""
    label, inner, inner_start = "none", None, -1.0
    for e in cpu:
        a, b = e.time_range.start, e.time_range.end
        if not a <= t < b:
            continue
        if e.name in LABELS:
            label = e.name
        elif e.name != SPAN and a > inner_start:
            inner, inner_start = e.name, a
    return f"{label} | {inner or 'none'}"
