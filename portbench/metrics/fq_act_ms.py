"""Device milliseconds a step of activation fake-quant, in the forward and
in recomputation: the program's ``quant.fake_quant_act`` spans."""
from portbench.metrics.program_spans import span_ms


def read(trace, ctx):
    return span_ms(trace, "quant.fake_quant_act")
