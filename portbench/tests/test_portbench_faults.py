"""A run with the timed path broken underneath reads ``correct`` false:
once for each fault a training cell can have (one card: no exchange
between cards to leave out)."""
from __future__ import annotations

import pytest

from conftest import CELLS, ROOT, shrink
from portbench import faults
from portbench.kinds import train
from portbench.run import run_cell


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_reads_incorrect(cell, fault, monkeypatch):
    real = train.Program.__init__

    def planted(self, spec, opt, seed, device, fault_=None):
        real(self, spec, opt, seed, device, fault)

    monkeypatch.setattr(train.Program, "__init__", planted)
    out = run_cell(ROOT, cell, 31337, 0.1, False, device="cpu",
                   shrink=shrink(cell))
    assert out["correct"] is False, out["checks"]
