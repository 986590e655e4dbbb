"""Port parity: repro_torch.launch (batch specs, roofline, report, the
ATen-level cost counter) against repro.launch, and the kernels' custom ops
(fake implementations, FLOP formulas) against their plain versions.

Tolerances: the batch specs, model FLOPs, report text and FLOP counts are
compared exactly; the roofline's derived fields are float expressions of
the same numbers, compared at rtol 1e-12.
"""
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

import repro.configs as jconfigs
import repro_torch.configs as configs
from repro.launch import report as jreport
from repro.launch import roofline as jrl
from repro.models.registry import make_batch_spec as jax_batch_spec
from repro_torch.device import card_trace
from repro_torch.kernels import cost
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref, attention_fwd_ref,
)
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_chunked_ref
from repro_torch.launch import hlo_cost, report
from repro_torch.launch import roofline as rl
from repro_torch.models import build_model, make_batch_spec

ARCHS = configs.arch_names()
SHAPES = [s.name for s in configs.ALL_SHAPES]
_DTYPES = {torch.int32: jnp.int32, torch.bfloat16: jnp.bfloat16,
           torch.float32: jnp.float32}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_spec_matches_jax(arch, shape):
    want = jax_batch_spec(jconfigs.get_config(arch),
                          jconfigs.shape_by_name(shape))
    got = make_batch_spec(configs.get_config(arch),
                          configs.shape_by_name(shape))
    assert list(got) == list(want)
    for name, spec in want.items():
        assert tuple(got[name].shape) == tuple(spec.shape), name
        assert _DTYPES[got[name].dtype] == spec.dtype, name
        assert got[name].device.type == "meta"


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_jax(arch, shape):
    assert rl.model_flops(configs.get_config(arch),
                          configs.shape_by_name(shape)) == jrl.model_flops(
        jconfigs.get_config(arch), jconfigs.shape_by_name(shape))


def test_report_fields_are_jax_formulas_with_h100_constants(monkeypatch):
    """With the JAX module's constants set to the port's (H100 peak and
    HBM, NVLink as its one link rate), every derived field agrees when the
    collectives run on in-pod axes; a collective on the pod axis is
    charged at the InfiniBand rate."""
    monkeypatch.setattr(jrl, "PEAK_FLOPS", rl.PEAK_FLOPS)
    monkeypatch.setattr(jrl, "HBM_BW", rl.HBM_BW)
    monkeypatch.setattr(jrl, "ICI_BW", rl.NVLINK_BW)
    cfg = configs.get_config("qwen3-1.7b")
    shape = configs.shape_by_name("train_4k")
    coll = {"all-gather": 3e9, "all-reduce": 5e9, "reduce-scatter": 2e9,
            "all-to-all": 0.0, "collective-permute": 0.0}
    kw = dict(arch=cfg.name, shape="train_4k", mesh="single", chips=256,
              hlo_flops=4.1e18, hlo_bytes=2.3e15,
              coll_bytes=sum(coll.values()), coll_breakdown=coll,
              model_flops=rl.model_flops(cfg, shape))
    want = jrl.RooflineReport(**kw)
    for by_axis in ({"model": kw["coll_bytes"]},
                    {"model": 7e9, "data": 3e9}):
        got = rl.RooflineReport(**kw, coll_by_axis=by_axis)
        for field in ("t_compute", "t_memory", "t_collective",
                      "useful_flops_ratio", "roofline_fraction"):
            assert getattr(got, field) == pytest.approx(
                getattr(want, field), rel=1e-12), field
        assert got.bottleneck == want.bottleneck
    pod = rl.RooflineReport(**kw, coll_by_axis={"pod": 1e10})
    assert pod.t_collective == pytest.approx(1e10 / (256 * rl.IB_BW))
    assert pod.predicted_step_s == max(pod.t_compute, pod.t_memory,
                                       pod.t_collective)


def test_render_matches_jax():
    ok = {"t_compute": 0.123, "t_memory": 0.045, "t_memory_kernel_adj": 0.04,
          "t_collective": 0.5, "bottleneck": "collective",
          "useful_flops_ratio": 0.71, "roofline_fraction": 0.2,
          "roofline_fraction_kernel_adj": 0.21,
          "memory_per_device": {"peak_bytes_per_device": 3.2e10},
          "status": "ok"}
    results = {
        "qwen3-1.7b|train_4k|single": ok,
        "mamba2-130m|decode_32k|multi": dict(ok, bottleneck="memory"),
        "hubert-xlarge|decode_32k|single": {
            "status": "skipped",
            "reason": "skip: encoder-only arch has no decode step"},
        "zamba2-7b|long_500k|single": {"status": "error", "error": "x"},
    }
    assert report.render(results) == jreport.render(results)


def _counted_step(layers):
    cfg = configs.reduced(configs.get_config("qwen3-1.7b")).replace(
        layers=layers, dtype="float32")
    api = build_model(cfg, device="cpu")
    params = api.init(0)
    batch = {k: torch.zeros((2, 32), dtype=torch.int32)
             for k in ("tokens", "targets")}

    def step():
        loss = api.loss(params, batch)
        loss.backward()

    for p in [params]:
        for leaf in _leaves(p):
            leaf.requires_grad_(True)
    with hlo_cost.CostCounter() as c:
        step()
    return c.summary()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def test_counter_flops_and_bytes_grow_linearly_with_layers():
    """The counterpart of test_hlo_cost.py's trip-count tests: eager loops
    unroll, so each added layer adds the same FLOPs and bytes."""
    c1, c2, c4 = (_counted_step(n) for n in (1, 2, 4))
    for key in ("flops", "bytes"):
        per_layer = c2[key] - c1[key]
        assert per_layer > 0, key
        assert c4[key] - c2[key] == 2 * per_layer, key
    assert c1["by_op"]["mm"]["flops"] > 0
    assert sum(c1["collectives"].values()) == 0


def _count(fn):
    with hlo_cost.CostCounter() as c:
        fn()
    return c.summary()


def test_counter_counts_local_ops_and_no_collectives_on_plain_tensors():
    x, w = torch.randn(8, 16), torch.randn(16, 4)
    c = _count(lambda: x @ w)
    assert c["flops"] == 2 * 8 * 16 * 4
    assert c["bytes"] == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    c = _count(lambda: x.t().reshape(128))   # a view, a copy
    assert c["bytes"] == 2 * 4 * 8 * 16


def _memory_step(fake: bool):
    """A small train step's peak as the counter reads it, and MemTracker's
    reading of the same step."""
    import contextlib

    from torch.distributed._tools.mem_tracker import MemTracker

    with FakeTensorMode() if fake else contextlib.nullcontext():
        torch.manual_seed(0)
        w1 = torch.randn(64, 256, requires_grad=True)
        w2 = torch.randn(256, 64, requires_grad=True)
        x = torch.randn(32, 64)
        mt, c = MemTracker(), hlo_cost.CostCounter()
        mt.track_external(w1, w2, x)
        c.track_external([w1, w2, x])
        with mt, c:
            h = (x @ w1).relu()
            loss = (h.t()[:, :16] @ x[:16]).square().sum() + (
                h @ w2).exp().mean()
            del h
            loss.backward()
    peak = max(snap["Total"] for snap in
               mt.get_tracker_snapshot("peak").values())
    return c.peak_bytes, peak


@pytest.mark.parametrize("fake", [False, True])
def test_counter_memory_reads_as_memtracker(fake):
    """The counter's peak on a small train step (views, saved outputs,
    gradients) equals MemTracker's, exactly: on real tensors, and on fake
    tensors where both see the same storages."""
    got, want = _memory_step(fake)
    assert got == want > 0
    assert got == _memory_step(not fake)[0]


def test_counter_joins_views_and_waits_to_their_allocation():
    """A view holds its base's allocation and adds no bytes; the bytes go
    when the last holder dies.  A collective's wait on a fake tensor (a new
    tensor of the same data) joins the gathered allocation."""
    with FakeTensorMode():
        with hlo_cost.CostCounter() as c:
            x = torch.empty(1000)
            v = x[10:].view(10, 99)
            assert c.live_bytes == c.peak_bytes == 4000
            del x
            assert c.live_bytes == 4000
            del v
            assert c.live_bytes == 0
    assert "wait_tensor" in hlo_cost._UNMARKED_VIEWS


@pytest.mark.parametrize("offset", [0, 1024, 3072])
def test_causal_query_shard_is_charged_as_the_last(offset):
    """A causal flash launch on a query shard of its keys (1024 of 4096)
    is charged as the axis's last shard, q_offset 3072, whichever shard
    was traced; a launch on all the keys keeps its offset."""
    b, h, hkv, d = 2, 4, 2, 64
    with FakeTensorMode():
        q = torch.empty(b, h, 1024, d, dtype=torch.bfloat16)
        k = torch.empty(b, hkv, 4096, d, dtype=torch.bfloat16)
        with hlo_cost.CostCounter() as c:
            o, lse = torch.ops.repro_torch.flash_fwd_lse(q, k, k, True, 0.1,
                                                         offset)
            torch.ops.repro_torch.flash_bwd(q, k, k, o, lse, o,
                                            torch.empty(b, h, 1024), True,
                                            0.1, offset)
        with hlo_cost.CostCounter() as whole:
            torch.ops.repro_torch.flash_fwd(k, k, k, True, 0.1, 0)
    ops = c.summary()["by_op"]
    assert ops["flash_fwd_lse"]["flops"] == cost.flash_flops(
        b, h, 1024, 4096, d, True, 2, 3072)
    assert ops["flash_fwd_lse"]["bytes"] == cost.flash_bytes(
        b, h, hkv, 1024, 4096, d, True, 2, 3072)
    assert ops["flash_bwd"]["flops"] == cost.flash_bwd_flops(
        b, h, 1024, 4096, d, True, 2, 3072)
    assert whole.summary()["flops"] == cost.flash_flops(
        b, hkv, 4096, 4096, d, True, 2, 0)


def _qkv(b, h, hkv, s, d, dtype):
    return (torch.empty(b, h, s, d, dtype=dtype),
            torch.empty(b, hkv, s, d, dtype=dtype),
            torch.empty(b, hkv, s, d, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_custom_ops_fake_outputs(dtype):
    """The fake implementations give what the kernels write: o in
    [B, S, H, d] memory order in q's type, the lse float32 [B, H, S], and
    dq, dk, dv laid out as q, k, v."""
    with FakeTensorMode():
        q, k, v = _qkv(2, 4, 2, 64, 32, dtype)
        o = torch.ops.repro_torch.flash_fwd(q, k, v, True, 0.1, 0)
        o2, lse = torch.ops.repro_torch.flash_fwd_lse(q, k, v, True, 0.1, 0)
        grads = torch.ops.repro_torch.flash_bwd(
            q, k, v, o2, lse, o2, torch.empty(2, 4, 64), True, 0.1, 0)
    want_stride = torch.empty(2, 64, 4, 32).transpose(1, 2).stride()
    for out in (o, o2):
        assert out.shape == q.shape and out.dtype == dtype
        assert out.stride() == want_stride
    assert lse.shape == (2, 4, 64) and lse.dtype == torch.float32
    for g, t in zip(grads, (q, k, v)):
        assert g.shape == t.shape and g.dtype == dtype


def test_ssd_custom_ops_fake_outputs():
    with FakeTensorMode():
        dtx = torch.empty(2, 3, 40, 16)
        dta = torch.empty(2, 3, 40)
        b = torch.empty(2, 40, 8)[:, None].expand(2, 3, 40, 8)
        scratch = torch.empty(sum(ssd_ops.scratch_sizes(2, 3, 40, 8, 16,
                                                        16)))
        y = torch.ops.repro_torch.ssd_scan(dta, dtx, b, b, scratch, 16)
        y2, h = torch.ops.repro_torch.ssd_scan_state(dta, dtx, b, b,
                                                     scratch, 16)
    for out in (y, y2):
        assert out.shape == dtx.shape and out.dtype == torch.float32
        assert out.stride() == torch.empty(2, 40, 3, 16).transpose(
            1, 2).stride()
    assert h.shape == (2, 3, 8, 16) and h.dtype == torch.float32


def _plain_flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_flash_flop_formulas_count_the_plain_products():
    """float32, full attention: the forward kernel issues the plain
    version's two products; the backward's seven products are the plain
    backward's five with s and dp recomputed (7/5 of them), plus the rows'
    dot D.  bf16 adds P V's second term (3 products) and the split ds."""
    b, h, hkv, s, d = 1, 4, 2, 48, 16
    q, k, v = (torch.randn(b * n, s, d) for n in (h, hkv, hkv))
    plain_fwd = _plain_flops(lambda: attention_fwd_ref(
        q, k, v, q_heads=h, kv_heads=hkv, causal=False))
    assert cost.flash_flops(b, h, s, s, d, False, 4) == plain_fwd
    out, lse = attention_fwd_ref(q, k, v, q_heads=h, kv_heads=hkv,
                                 causal=False)
    plain_bwd = _plain_flops(lambda: attention_bwd_ref(
        q, k, v, out, lse, out, q_heads=h, kv_heads=hkv, causal=False))
    assert plain_bwd == 5 * 2 * b * h * s * s * d
    assert cost.flash_bwd_flops(b, h, s, s, d, False, 4) == \
        plain_bwd * 7 / 5 + 2 * b * h * s * d
    assert cost.flash_flops(b, h, s, s, d, False, 2) == plain_fwd * 3 / 2
    # the registered formula is the cost module's, causal pairs included
    with FakeTensorMode():
        qf, kf, vf = _qkv(b, h, hkv, s, d, torch.bfloat16)
        with FlopCounterMode(display=False) as fc:
            torch.ops.repro_torch.flash_fwd_lse(qf, kf, vf, True, 0.25, 8)
    assert fc.get_total_flops() == cost.flash_flops(b, h, s, s, d, True, 2,
                                                     8)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_flop_formula_counts_the_plain_products(chunk):
    """The scan kernel's products are the chunked plain version's, less
    the score tiles' upper triangles it skips."""
    bh, s, p, n = 3, 32, 8, 4
    args = (torch.randn(bh, s), torch.randn(bh, s, p), torch.randn(bh, s, n),
            torch.randn(bh, s, n))
    plain = _plain_flops(lambda: ssd_chunked_ref(*args, chunk=chunk))
    skipped = 2 * bh * (s // chunk) * chunk * (chunk - 1) // 2 * (n + p)
    assert cost.ssd_flops(1, bh, s, n, p, chunk) == plain - skipped


def test_kernel_route_under_card_trace():
    """Inside card_trace a fake tensor takes the kernel's route (its fake
    custom op) and real CPU tensors the plain versions, but for the SSD
    scan, whose custom ops run their plain versions on them (so that a
    real run of a traced cell allocates what the fake trace counts);
    outside it CPU tensors take the plain versions, fake or not."""
    from repro_torch.kernels.bitlinear.ops import resolve_backend

    real = torch.zeros(2, 3, 4, 5, requires_grad=True)
    assert ssd_ops._resolve("auto", real) == "reference"
    with card_trace():
        assert resolve_backend("auto", real) == "reference"
        assert ssd_ops._resolve("auto", real) == "cuda"
        with FakeTensorMode():
            fake = torch.zeros(2, 3, 4, 5, requires_grad=True)
            assert resolve_backend("auto", fake) == "cuda"
            assert ssd_ops._resolve("auto", fake) == "cuda"
    with FakeTensorMode():
        assert resolve_backend("auto", torch.zeros(2)) == "reference"
        assert ssd_ops._resolve("auto", torch.zeros(2)) == "reference"


@pytest.mark.parametrize("return_state", [False, True])
def test_traced_ssd_on_cpu_tensors_runs_the_plain_versions(return_state):
    """Under card_trace the SSD scan on real CPU tensors goes through the
    custom ops, forward and backward (B and C shared by the heads, a
    terminal state's gradient entering), and gives the plain route's
    values and gradients bit for bit, launching nothing; the counter sees
    the ops, not the plain versions' products."""
    gen = torch.Generator().manual_seed(0)
    nb, nh, s, p, n, chunk = 2, 3, 40, 8, 4, 16
    args = [-torch.rand(nb, nh, s, generator=gen),
            torch.randn(nb, nh, s, p, generator=gen),
            torch.randn(nb, s, n, generator=gen),
            torch.randn(nb, s, n, generator=gen)]

    def run():
        leaves = [t.clone().requires_grad_() for t in args]
        out = ssd_ops.ssd(*leaves, chunk=chunk, return_state=return_state)
        y, h = out if return_state else (out, None)
        loss = (y * y).sum() + (h.sum() if h is not None else 0)
        loss.backward()
        return [y, *(t.grad for t in leaves)]

    want = run()
    ssd_ops.reset_launches()
    counter = hlo_cost.CostCounter()
    with card_trace(), counter:
        got = run()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not any(ssd_ops.LAUNCHES.values())
    fwd = "ssd_scan_state" if return_state else "ssd_scan"
    assert counter.by_op[fwd]["calls"] == 1
    assert counter.by_op["ssd_scan_bwd"]["calls"] == 1
    assert counter.by_op[fwd]["flops"] == cost.ssd_flops(nb, nh, s, n, p,
                                                         chunk)
    assert "bmm" not in counter.by_op


def test_cost_formulas_are_chip_smokes_bounds():
    """chip_smoke.py's bounds are the package's formulas (one copy)."""
    import chip_smoke

    args = (1, 16, 16, 4096, 4096, 128, True, 2, 1024)
    assert chip_smoke.flash_bound(*args) == cost.flash_bound(*args)
    assert chip_smoke.flash_bwd_bound(*args) == cost.flash_bwd_bound(*args)
    ssd = (1, 112, 4096, 64, 64, 128, True)
    assert chip_smoke.ssd_bound(*ssd) == cost.ssd_bound(*ssd)
    assert fa.BYTES[torch.ops.repro_torch.flash_fwd] is not None

