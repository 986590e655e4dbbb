"""Every piece of every cell is found by name, and ``BENCHMARK.json``
keeps to the form its readers expect."""
from __future__ import annotations

import json
import re

from conftest import ROOT
from portbench import cost, kinds, metrics, reference
from portbench.run import cell_context

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NUMBERS = {"loss_gap", "grad_gap", "grad_median_gap", "change_gap",
           "change_median_gap"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_each_cell_finds_its_files():
    for cell in BENCH["workloads"]:
        ctx = cell_context(ROOT, cell["name"])
        spec = ctx["config"]["as_run"]
        assert kinds.load(ctx["traffic"]["kind"]).run
        assert reference.load(spec["family"]).leaves(spec)
        assert cost.load(f"model_{spec['family']}").step_flops
        assert set(ctx["limits"]) <= NUMBERS and ctx["limits"]
        for name in ctx["per_layer"]:
            assert metrics.load(name).read


def test_every_per_layer_metric_has_a_reader_and_names_its_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert metrics.load(m["name"]).read
        assert set(m["workloads"]) <= cells
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_names_units_and_bounds():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for e in BENCH["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    assert any(e["name"] == "setup_s" for e in BENCH["end_to_end"])
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(BENCH["paths"][0] + "/")
