"""Cell drivers, one a kind of traffic: ``kinds/<kind>.py``'s
``run(ctx)`` runs one cell once (``kind`` is the traffic file's)."""
from __future__ import annotations

import importlib


def load(kind: str):
    return importlib.import_module(f"portbench.kinds.{kind}")
