"""The yardstick's work formulas, one file a kernel or model family.

Each file counts what the algorithm needs for given inputs (operations, and
bytes with each input read once and each output written once), never how an
implementation issues it, so that a kernel's share of its bound cannot pass
100 % whatever implements it.  ``load(name)`` finds ``cost/<name>.py``.
"""
from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"portbench.cost.{name}")
