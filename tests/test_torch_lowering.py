"""Port parity: repro_torch.legion.lower(spec) against repro.legion.lower.

Every registry architecture's ``zoo_spec(reduced(cfg))`` lowers in both
packages to the same stages and operands; ``Machine.run`` gives outputs
bit-exact against the JAX Machine and against ``reference_outputs`` at
window and at kernel granularity (where the MoE's skipped experts run the
block-sparse kernel's plain version), with equal validations.  MoE expert
skipping saves exactly the skipped experts' bytes (``skip_eq_err`` 0, as
benchmarks/workload_zoo.py computes it), and the pipelined executor's
overlapped-round reports are equal.  Bad specs raise at construction.
"""
import dataclasses

import numpy as np
import pytest

import repro.configs as jconfigs
import repro.core as jcore
import repro.legion as jlegion
import repro_torch.configs as tconfigs
import repro_torch.core as tcore
import repro_torch.legion as tlegion
from repro_torch.legion import (
    AttentionLoweringSpec,
    HybridSpec,
    MoESpec,
    SSDSpec,
    lower,
)

PACKAGES = ((jconfigs, jcore, jlegion), (tconfigs, tcore, tlegion))


def _machine(core, legion, granularity):
    kw = {"device": "cpu"} if legion is tlegion else {}
    return legion.Machine(core.dlegion(), granularity=granularity, **kw)


def _same_operand(a, b):
    if isinstance(a, (jlegion.Ref, tlegion.Ref)):
        assert type(b).__name__ == "Ref" and a.producers == b.producers
        assert (a.transform is None) == (b.transform is None)
    elif a is None:
        assert b is None
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _skip_eq_err(legion, machine, spec, rep):
    """benchmarks/workload_zoo.py's expert-skip identity: the k-of-E step's
    weight bytes equal the dense-E twin's minus the skipped experts'."""
    dense = dataclasses.replace(spec, top_k=spec.n_experts, chosen=None)
    rep_d = machine.run(legion.lower(dense))
    assert rep_d.ok
    total = lambda r: sum(sr.traffic.weight_bytes        # noqa: E731
                          for sr in r.stage_reports.values())
    _, skipped = spec.routing()
    skipped_bytes = sum(rep_d.stage_reports[n].traffic.weight_bytes
                        for e in skipped for n in legion.moe_stage_names(e))
    wk, wd = total(rep), total(rep_d)
    return abs(wk - (wd - skipped_bytes)) / wd


@pytest.mark.parametrize("granularity", ["window", "kernel"])
@pytest.mark.parametrize("arch", jconfigs.arch_names())
def test_registry_zoo_specs_match_reference(arch, granularity):
    assert arch in tconfigs.arch_names()
    progs, reps, specs = [], [], []
    for configs, core, legion in PACKAGES:
        spec = legion.zoo_spec(configs.reduced(configs.get_config(arch)))
        prog = legion.lower(spec)
        machine = _machine(core, legion, granularity)
        rep = machine.run(prog)
        assert rep.ok
        ref = legion.reference_outputs(prog)
        assert set(rep.outputs) == set(ref)
        for name, out in rep.outputs.items():
            np.testing.assert_array_equal(out, ref[name])
        if isinstance(spec, (jlegion.MoESpec, tlegion.MoESpec)):
            assert _skip_eq_err(legion, machine, spec, rep) == 0.0
        progs.append(prog)
        reps.append(rep)
        specs.append(spec)
    assert type(specs[0]).__name__ == type(specs[1]).__name__
    (jp, tp), (jr, tr) = progs, reps
    assert jp.names == tp.names
    for js, ts in zip(jp.topo_order(), tp.topo_order()):
        assert js.name == ts.name and js.deps == ts.deps
        assert js.after == ts.after and js.w_source == ts.w_source
        assert js.ztb == ts.ztb and js.ztb_sparsity == ts.ztb_sparsity
        assert dataclasses.asdict(js.workload) == \
            dataclasses.asdict(ts.workload)
        _same_operand(js.x, ts.x)
        _same_operand(js.w, ts.w)
    for name in jp.names:
        assert tr.outputs[name].dtype == jr.outputs[name].dtype
        np.testing.assert_array_equal(tr.outputs[name], jr.outputs[name])
        assert tr[name].mode.name == jr[name].mode.name
        assert str(tr[name].traffic_validation) == \
            str(jr[name].traffic_validation)
        assert str(tr[name].cycle_validation) == \
            str(jr[name].cycle_validation)


@pytest.mark.parametrize("arch", jconfigs.arch_names())
def test_registry_zoo_pipeline_reports_match_reference(arch):
    """Under a PipelinedExecutor the overlapped-round schedules of every
    zoo program are equal in both packages, level by level."""
    reports = []
    for configs, core, legion in PACKAGES:
        prog = legion.lower(legion.zoo_spec(
            configs.reduced(configs.get_config(arch))))
        kw = {"device": "cpu"} if legion is tlegion else {}
        rep = legion.Machine(core.dlegion(), granularity="kernel",
                             backend=legion.PipelinedExecutor(),
                             **kw).run(prog, check_outputs=False)
        assert rep.pipeline is not None
        assert rep.pipeline.overlapped_cycles <= rep.pipeline.serial_cycles
        reports.append(rep.pipeline)
    assert [dataclasses.asdict(lv) for lv in reports[1].levels] == \
        [dataclasses.asdict(lv) for lv in reports[0].levels]


def test_moe_kernel_granularity_runs_skipped_experts_block_sparse():
    from repro_torch.legion.modes import BLOCK_SPARSE

    spec = MoESpec(d_model=64, d_ff=48, n_experts=8, top_k=2, tokens=16)
    rep = _machine(tcore, tlegion, "kernel").run(lower(spec))
    chosen, skipped = spec.routing()
    for e in range(spec.n_experts):
        for name in tlegion.moe_stage_names(e):
            sparse = rep[name].mode.backend == BLOCK_SPARSE
            assert sparse == (e in skipped)
            if e in skipped:
                assert not rep.outputs[name].any()


def test_spec_construction_errors():
    """tests/test_workload_zoo.py's construction errors, in the port."""
    with pytest.raises(ValueError, match="weight_bits"):
        MoESpec(d_model=32, d_ff=16, n_experts=4, top_k=2, tokens=8,
                weight_bits=3)
    with pytest.raises(ValueError, match="top_k"):
        MoESpec(d_model=32, d_ff=16, n_experts=4, top_k=5, tokens=8)
    with pytest.raises(ValueError, match="d_ff"):
        MoESpec(d_model=32, d_ff=0, n_experts=4, top_k=2, tokens=8)
    with pytest.raises(ValueError, match="page"):
        MoESpec(d_model=32, d_ff=16, n_experts=4, top_k=2, tokens=8,
                page_tokens=16)
    with pytest.raises(ValueError, match="page"):
        SSDSpec(heads=2, chunk=16, state=8, head_dim=8,
                page_tables=[[0]])
    with pytest.raises(ValueError, match="int8"):
        SSDSpec(heads=2, chunk=16, state=8, head_dim=8, weight_bits=2)
    with pytest.raises(ValueError, match="divisible"):
        AttentionLoweringSpec(heads=4, kv_heads=3, head_dim=32, hidden=128,
                              seq_len=32)
    with pytest.raises(ValueError, match="layers"):
        SSDSpec(heads=2, chunk=16, state=8, head_dim=8, layers=0)
    with pytest.raises(ValueError, match="sub-spec"):
        HybridSpec(ssd=SSDSpec(heads=2, chunk=16, state=8, head_dim=8))
    with pytest.raises(TypeError, match="LoweringSpec"):
        lower("not a spec")
