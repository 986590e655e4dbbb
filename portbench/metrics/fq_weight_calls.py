"""Weight fake-quant calls a step, in the forward and in recomputation:
the program's ``quant.fake_quant_weight`` spans."""
from portbench.metrics.program_spans import span_calls


def read(trace, ctx):
    return span_calls(trace, "quant.fake_quant_weight")
