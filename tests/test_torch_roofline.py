"""Port parity: repro_torch.legion.roofline against repro.legion.roofline.

``find_stall_knee`` and ``sweep_bandwidth`` (measured through Machines with
``cross_validate=True`` on ZTB-pruned weights) give equal knees and equal
``SweepPoint``s in both packages, across the W1.58 / W4 / W8 +-ZTB modes
of tests/test_roofline.py, on a small two-Legion config.
"""
import dataclasses
import json

import pytest

import repro.core.config as jconfig
import repro.core.workloads as jwl
import repro.legion as jlegion
import repro_torch.core.config as tconfig
import repro_torch.core.workloads as twl
import repro_torch.legion as tlegion

MODE_MATRIX = [(bits, ztb) for bits in (2, 4, 8) for ztb in (False, True)]


def _cfg(mod, legions=2, cores=4, d=8):
    return mod.AcceleratorConfig(
        name=f"T-{legions}L", dataflow=mod.Dataflow.ADIP, units=legions,
        cores=cores, d=d, pipeline=cores // 2, adaptive=True,
        packed_weights=True,
    )


def _wls(mod, bits):
    base = dict(stage="qkv_proj", m=16, k=128, n=96, weight_bits=bits,
                count=1, shared_input=True)
    return [mod.GEMMWorkload(**base),
            mod.GEMMWorkload(**dict(base, stage="out_proj", k=64, n=64,
                                    weight_bits=4))]


@pytest.mark.parametrize("bits,ztb", MODE_MATRIX)
def test_sweep_and_knee_match_reference(bits, ztb):
    sweeps, knees = [], []
    for mod, wl_mod, legion in ((jconfig, jwl, jlegion),
                                (tconfig, twl, tlegion)):
        cfg, wls = _cfg(mod), _wls(wl_mod, bits)
        knee = legion.find_stall_knee(cfg, wls)
        kw = {"device": "cpu"} if legion is tlegion else {}
        sweep = legion.sweep_bandwidth(
            cfg, wls, [knee / 4, knee / 1.5, knee * 2],
            cross_validate=True, ztb_sparsity=0.5 if ztb else 0.0, **kw)
        assert sweep.worst_rel_err == 0.0
        knees.append(knee)
        sweeps.append(sweep)
    assert knees[0] == knees[1]
    j, t = sweeps
    assert [dataclasses.asdict(p) for p in t.points] == \
        [dataclasses.asdict(p) for p in j.points]
    assert json.dumps(t.as_dict(), sort_keys=True) == \
        json.dumps(j.as_dict(), sort_keys=True)
    assert t.to_chrome() == j.to_chrome()


def test_default_points_and_hbm_budget_match_reference():
    for legions in (1, 2, 8):
        jc, tc = _cfg(jconfig, legions), _cfg(tconfig, legions)
        assert tlegion.hbm_bytes_per_cycle(tc) == \
            jlegion.hbm_bytes_per_cycle(jc)
        j = jlegion.sweep_bandwidth(jc, _wls(jwl, 2))
        t = tlegion.sweep_bandwidth(tc, _wls(twl, 2), device="cpu")
        assert t.as_dict() == j.as_dict()
