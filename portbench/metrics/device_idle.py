"""Percent of the profiled span's wall in which no operation ran on the
device."""


def read(trace, ctx):
    if trace["busy_s"] <= 0:
        return None
    return 100.0 * (trace["window_s"] - trace["busy_s"]) / trace["window_s"]
