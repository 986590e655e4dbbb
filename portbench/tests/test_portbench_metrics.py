"""Each per-layer reader on traced spans recorded on the card (trimmed
summaries of ``portbench.trace``, one a cell, in ``tests/data``), and on a
span in which nothing ran on the device."""
from __future__ import annotations

import json

import pytest

from conftest import ROOT
from portbench import metrics
from portbench.cost import flash_bwd, flash_fwd, model_dense, ssd_bwd, ssd_fwd
from portbench.run import cell_context

DATA = ROOT / "portbench" / "tests" / "data"
SAMPLES = {"bitnet-1.58b.train-4k": "trace-bitnet-1.58b.train-4k.json",
           "zamba2-7b-30l.train-4k": "trace-zamba2-7b-30l.train-4k.json"}
EMPTY = {"window_s": 0.5, "busy_s": 0.0, "steps": 2, "kernels": {},
         "ops": {}, "device_ops": [], "idle_gaps": []}


def _ctx(cell, step_s=0.9):
    ctx = cell_context(ROOT, cell)
    return ctx, {"spec": ctx["config"]["as_run"], "traffic": ctx["traffic"],
                 "elt": 2, "step_s": step_s}


def _share(trace, op, bound):
    calls, us = trace["ops"][op]
    return 100.0 * bound * calls / (us / 1e6)


@pytest.mark.parametrize("cell", sorted(SAMPLES))
def test_readers_on_a_recorded_span(cell):
    trace = json.loads((DATA / SAMPLES[cell]).read_text())
    ctx, mctx = _ctx(cell)
    spec, t = mctx["spec"], mctx["traffic"]
    got = {name: metrics.load(name).read(trace, mctx)
           for name in ctx["per_layer"]}
    assert got["device_idle.train"] == pytest.approx(
        100 * (trace["window_s"] - trace["busy_s"]) / trace["window_s"])
    ew = sum(v[1] for k, v in trace["kernels"].items()
             if "elementwise_kernel" in k or "reduce_kernel" in k)
    assert got["elementwise_ms.train"] == pytest.approx(
        ew / 1e3 / trace["steps"])
    assert 0 < got["step_mfu.train"] < 100
    args = (t["batch"], spec["n_heads"], spec["kv_heads"], t["seq"], t["seq"],
            spec["head_dim"], True)
    fwd = max(flash_fwd.ops(*args) / 989e12,
              flash_fwd.nbytes(*args, 2) / 3.35e12)
    bwd = max(flash_bwd.ops(*args) / 989e12,
              flash_bwd.nbytes(*args, 2) / 3.35e12)
    assert got["flash_fwd_roofline.train"] == pytest.approx(
        _share(trace, "repro_torch::flash_fwd_lse", fwd))
    assert got["flash_bwd_roofline.train"] == pytest.approx(
        _share(trace, "repro_torch::flash_bwd", bwd))
    if spec["family"] == "hybrid":
        nh = spec["ssm_expand"] * spec["d_model"] // spec["ssm_head_dim"]
        a = (t["batch"], nh, t["seq"], spec["ssm_state"],
             spec["ssm_head_dim"])
        f = max(ssd_fwd.ops(*a, spec["ssd_chunk"], True) / 495e12,
                ssd_fwd.nbytes(*a, True) / 3.35e12)
        b = max(ssd_bwd.ops(*a, spec["ssd_chunk"], True) / 495e12,
                ssd_bwd.nbytes(*a, True) / 3.35e12)
        assert got["ssd_fwd_roofline.train"] == pytest.approx(
            _share(trace, "repro_torch::ssd_scan", f))
        assert got["ssd_bwd_roofline.train"] == pytest.approx(
            _share(trace, "repro_torch::ssd_scan_bwd", b))
    for name, value in got.items():
        assert value is not None and value >= 0, name
        if "roofline" in name or "mfu" in name:
            assert value <= 100, name


@pytest.mark.parametrize("cell", sorted(SAMPLES))
def test_readers_find_nothing_where_nothing_ran(cell):
    ctx, mctx = _ctx(cell)
    for name in ctx["per_layer"]:
        assert metrics.load(name).read(EMPTY, mctx) is None, name


def test_mfu_follows_the_step_time():
    cell = "bitnet-1.58b.train-4k"
    trace = json.loads((DATA / SAMPLES[cell]).read_text())
    _, fast = _ctx(cell, 0.5)
    _, slow = _ctx(cell, 1.0)
    read = metrics.load("step_mfu.train").read
    assert read(trace, fast) == pytest.approx(2 * read(trace, slow))
    flops = model_dense.step_flops(fast["spec"], fast["traffic"]["batch"],
                                   fast["traffic"]["seq"])
    assert read(trace, fast) == pytest.approx(
        100 * flops / (989e12 * 0.5), rel=1e-9)
