"""Device milliseconds a step of the backward: the program's
``train.backward`` span, opened on the autograd thread that runs it, the
remat's recomputation included."""
from portbench.metrics.program_spans import span_ms


def read(trace, ctx):
    return span_ms(trace, "train.backward")
