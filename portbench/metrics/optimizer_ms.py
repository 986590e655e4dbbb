"""Device milliseconds a step of the AdamW update (global norm, clip,
every leaf): the program's ``train.optimizer`` span."""
from portbench.metrics.program_spans import span_ms


def read(trace, ctx):
    return span_ms(trace, "train.optimizer")
