"""The whole step's model FLOPs over the bf16 tensor-core peak times the
step's seconds (steps outside the profiled span), in percent.  Model
FLOPs come from the configuration's shapes (``cost/model_<family>.py``):
one forward and its backward, no recomputation."""
from portbench.cost import load
from portbench.cost.peaks import BF16_OPS_PER_S


def read(trace, ctx):
    if not ctx.get("step_s") or trace["busy_s"] <= 0:
        return None
    t = ctx["traffic"]
    flops = load(f"model_{ctx['spec']['family']}").step_flops(
        ctx["spec"], t["batch"], t["seq"])
    return 100.0 * flops / (BF16_OPS_PER_S * ctx["step_s"])
