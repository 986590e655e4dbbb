"""Device milliseconds a step of the loss's forward: the program's
``train.forward`` spans, one a microbatch."""
from portbench.metrics.program_spans import span_ms


def read(trace, ctx):
    return span_ms(trace, "train.forward")
