"""The plain reference, one module a model family (``<family>.py``), with
the parts they share in ``common.py``.  Plain PyTorch in float32; it
imports nothing of the program under test."""
from __future__ import annotations

import importlib


def load(family: str):
    return importlib.import_module(f"portbench.reference.{family}")
