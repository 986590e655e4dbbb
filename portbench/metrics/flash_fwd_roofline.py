"""The attention forward kernel's share of its bound: the calls of
``repro_torch::flash_fwd_lse`` (the training forward, the lse written)
over their device time, each call's bound from ``cost/flash_fwd.py`` at
the cell's shapes."""
from portbench.cost import flash_fwd
from portbench.cost.peaks import bound_s
from portbench.metrics import op_roofline

OPS = ("repro_torch::flash_fwd_lse",)


def read(trace, ctx):
    s, t = ctx["spec"], ctx["traffic"]
    args = (t["batch"], s["n_heads"], s["kv_heads"], t["seq"], t["seq"],
            s["head_dim"], True)
    elt = ctx["elt"]
    return op_roofline(trace, OPS, bound_s(
        flash_fwd.ops(*args), flash_fwd.nbytes(*args, elt), elt))
