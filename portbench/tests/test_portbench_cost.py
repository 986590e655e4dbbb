"""The frozen work formulas equal the port's ``kernels/cost.py`` wherever
that file counts the algorithm's work; the model FLOPs follow from the
shapes."""
from __future__ import annotations

import json

import pytest

from conftest import ROOT
from portbench.cost import (flash_bwd, flash_fwd, model_dense,
                            model_hybrid, ssd_bwd, ssd_fwd)
from repro_torch.kernels import cost

FLASH = [(1, 16, 16, 4096, 4096, 128, True, 2), (1, 32, 32, 4096, 4096,
                                                  112, True, 2),
         (2, 8, 2, 1000, 1000, 64, False, 4), (1, 4, 4, 300, 300, 32, True, 4)]
SSD = [(1, 112, 4096, 64, 64, 128, True), (2, 24, 1000, 128, 64, 128,
                                           False), (1, 8, 300, 16, 16, 32,
                                                    True)]


@pytest.mark.parametrize("b,h,hkv,s,sk,d,causal,elt", FLASH)
def test_flash_formulas_equal_the_ports(b, h, hkv, s, sk, d, causal, elt):
    assert flash_fwd.pairs(s, sk, causal) == cost.pairs(s, sk, causal)
    assert flash_fwd.nbytes(b, h, hkv, s, sk, d, causal, elt, lse=False) \
        == cost.flash_bytes(b, h, hkv, s, sk, d, causal, elt)
    assert flash_fwd.ops(b, h, hkv, s, sk, d, causal) == \
        4.0 * b * h * cost.pairs(s, sk, causal) * d
    assert flash_bwd.nbytes(b, h, hkv, s, sk, d, causal, elt) == \
        cost.flash_bwd_bytes(b, h, hkv, s, sk, d, causal, elt)
    ms, _ = cost.flash_bwd_bound(b, h, hkv, s, sk, d, causal, elt)
    ops = flash_bwd.ops(b, h, hkv, s, sk, d, causal)
    rate = cost.BF16_OPS_PER_S if elt == 2 else cost.F32_OPS_PER_S
    assert ms == pytest.approx(max(ops / rate, flash_bwd.nbytes(
        b, h, hkv, s, sk, d, causal, elt) / cost.HBM_BYTES_PER_S) * 1e3)


@pytest.mark.parametrize("nb,nh,s,n,p,chunk,shared", SSD)
def test_ssd_formulas_equal_the_ports(nb, nh, s, n, p, chunk, shared):
    assert ssd_fwd.nbytes(nb, nh, s, n, p, shared, state=True) == \
        cost.ssd_bytes(nb, nh, s, n, p, shared)
    scores, per_head = cost._ssd_work(s, n, p, chunk)
    assert ssd_fwd.work(s, n, p, chunk) == (scores, per_head)
    assert ssd_bwd.ops(nb, nh, s, n, p, chunk, shared) == \
        cost.ssd_bwd_ops(nb, nh, s, n, p, chunk, shared)
    for dh in (False, True):
        assert ssd_bwd.nbytes(nb, nh, s, n, p, shared, dh) == \
            cost.ssd_bwd_bytes(nb, nh, s, n, p, shared, dh)


def test_ssd_backward_counts_the_shared_products_once_whatever_the_group():
    # the port's issued count grows with the head groups; the bound's work
    # is the group-of-all-heads count
    one = cost.ssd_bwd_flops(1, 112, 4096, 64, 64, 128, group=112)
    assert ssd_bwd.ops(1, 112, 4096, 64, 64, 128, True) <= one
    assert cost.ssd_bwd_flops(1, 112, 4096, 64, 64, 128, group=28) > one


def _spec(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())["as_run"]


def test_model_flops_from_shapes():
    spec = _spec("bitnet-1.58b")
    per_layer = 4 * 2560 * 2048 + 3 * 2560 * 6912
    want = 3 * (2 * 4096 * (32 * per_layer + 2560 * 32000)
                + 32 * 4 * 16 * 128 * (4096 * 4097 // 2))
    assert model_dense.step_flops(spec, 1, 4096) == want
    hybrid = model_hybrid.step_flops(_spec("zamba2-7b-30l"), 1, 4096)
    assert 8.5e13 < hybrid < 9.0e13
