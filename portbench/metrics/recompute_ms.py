"""Device milliseconds a step of the remat's recomputation inside the
backward (a part of ``backward_ms``): the program's
``models.layer_recompute`` spans."""
from portbench.metrics.program_spans import span_ms


def read(trace, ctx):
    return span_ms(trace, "models.layer_recompute")
