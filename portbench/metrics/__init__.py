"""Per-layer metric readers, one file a quantity: the metric
``<name>.<variant>`` is read by ``metrics/<name>.py``'s ``read(trace,
ctx)``, which returns a number or None where the traced span holds nothing
for it to read (the harness then leaves the metric out of the line).

``trace`` is ``portbench.trace``'s summary of the profiled span; ``ctx``
holds the cell's configuration as run (``spec``), its traffic, and
``step_s``, the mean seconds of a step outside the span."""
from __future__ import annotations

import importlib


def load(metric: str):
    return importlib.import_module(
        f"portbench.metrics.{metric.split('.')[0]}")


def op_roofline(trace, ops, bound_s: float):
    """Percent of the bound of one call that the calls of host ops
    ``ops`` reached on the device, over the span: bound x calls over
    their device time; None where no call ran on the device."""
    calls = sum(trace["ops"].get(op, [0, 0.0])[0] for op in ops)
    device_us = sum(trace["ops"].get(op, [0, 0.0])[1] for op in ops)
    if not calls or device_us <= 0:
        return None
    return 100.0 * bound_s * calls / (device_us / 1e6)
