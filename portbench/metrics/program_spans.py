"""Readers of the program's own spans (``repro_torch.obs.spans``): the
host-op span's ``ops[name] = [calls, device µs]``, where a span's device
time is ``FunctionEvent.device_time_total``, everything launched inside
it, its nested spans' work included.  Each value is a step's (over
``trace["steps"]``), and None where the span is absent or ran nothing on
the device (a program without the span, or a trace of the CPU)."""

PREFIX = "repro_torch."


def _found(trace, span):
    calls, us = trace["ops"].get(PREFIX + span, [0, 0.0])
    return (calls, us) if calls and us > 0 else None


def span_ms(trace, span):
    """Device milliseconds a step launched inside ``span``."""
    found = _found(trace, span)
    return None if found is None else found[1] / 1e3 / trace["steps"]


def span_calls(trace, span):
    """Calls of ``span`` a step."""
    found = _found(trace, span)
    return None if found is None else found[0] / trace["steps"]
