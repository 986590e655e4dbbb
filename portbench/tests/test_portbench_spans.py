"""The readers of the program's own spans (``metrics/program_spans.py``)
on the traced spans recorded on the card (``tests/data``: the summary
``trace-<cell>.json`` with the program's span entries of the same run,
``spans-<cell>.json``, laid over its ``ops``), and on a span in which
nothing ran on the device: each reads its span's device time or
calls a step; forward, backward and optimizer together hold the step's
device work once; the fake-quant counts are the remat schedule's."""
from __future__ import annotations

import json

import pytest

from conftest import ROOT
from portbench import metrics

DATA = ROOT / "portbench" / "tests" / "data"
SAMPLES = {"bitnet-1.58b.train-4k": "trace-bitnet-1.58b.train-4k.json",
           "zamba2-7b-30l.train-4k": "trace-zamba2-7b-30l.train-4k.json"}
EMPTY = {"window_s": 0.5, "busy_s": 0.0, "steps": 2, "kernels": {},
         "ops": {}, "device_ops": [], "idle_gaps": []}
SPANS = {"forward_ms.train": "train.forward",
         "backward_ms.train": "train.backward",
         "optimizer_ms.train": "train.optimizer",
         "recompute_ms.train": "models.layer_recompute",
         "fq_weight_ms.train": "quant.fake_quant_weight",
         "fq_act_ms.train": "quant.fake_quant_act",
         "fq_weight_calls.train": "quant.fake_quant_weight",
         "fq_act_calls.train": "quant.fake_quant_act"}
# calls a step of each fake-quantizer: BitNet's 7 projections x 32 layers
# x 3 forwards (the two-level remat); Zamba2's 31 projections a period (a
# shared block's 7, six Mamba blocks' 4) x 9 period forwards (5, and the
# first 4 again in the backward)
FQ_CALLS = {"bitnet-1.58b.train-4k": 7 * 32 * 3,
            "zamba2-7b-30l.train-4k": (7 + 6 * 4) * (5 + 4)}


def _trace(cell):
    trace = json.loads((DATA / SAMPLES[cell]).read_text())
    spans = json.loads((DATA / f"spans-{cell}.json").read_text())
    trace["ops"].update(spans["ops"])
    return trace


def _read(name, trace):
    return metrics.load(name).read(trace, {})


@pytest.mark.parametrize("name", sorted(SPANS))
@pytest.mark.parametrize("cell", sorted(SAMPLES))
def test_each_reader_reads_its_span(cell, name):
    trace = _trace(cell)
    calls, us = trace["ops"]["repro_torch." + SPANS[name]]
    want = (calls if name.endswith("_calls.train") else us / 1e3)
    assert _read(name, trace) == pytest.approx(want / trace["steps"])
    assert _read(name, EMPTY) is None


@pytest.mark.parametrize("cell", sorted(SAMPLES))
def test_forward_backward_and_optimizer_hold_the_step_once(cell):
    """The three spans' device time together is the step's, within 2 %:
    the backward's span is on the thread that runs it, and no kernel is
    counted twice."""
    trace = _trace(cell)
    kernels_ms = (sum(v[1] for v in trace["kernels"].values()) / 1e3
                  / trace["steps"])
    parts = sum(_read(n, trace) for n in ("forward_ms.train",
                                          "backward_ms.train",
                                          "optimizer_ms.train"))
    assert parts == pytest.approx(kernels_ms, rel=0.02)
    assert _read("recompute_ms.train", trace) < _read("backward_ms.train",
                                                      trace)
    fq = _read("fq_weight_ms.train", trace) + _read("fq_act_ms.train", trace)
    assert fq < parts


@pytest.mark.parametrize("cell", sorted(SAMPLES))
def test_fake_quant_calls_follow_the_remat_schedule(cell):
    trace = _trace(cell)
    assert _read("fq_weight_calls.train", trace) == FQ_CALLS[cell]
    assert _read("fq_act_calls.train", trace) == FQ_CALLS[cell]
