"""Device milliseconds a step of weight fake-quant, in the forward and in
recomputation: the program's ``quant.fake_quant_weight`` spans."""
from portbench.metrics.program_spans import span_ms


def read(trace, ctx):
    return span_ms(trace, "quant.fake_quant_weight")
