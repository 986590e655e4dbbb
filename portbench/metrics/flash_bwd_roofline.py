"""The attention backward's share of its bound: the calls of
``repro_torch::flash_bwd`` over their device time, each call's bound
from ``cost/flash_bwd.py`` at the cell's shapes."""
from portbench.cost import flash_bwd
from portbench.cost.peaks import bound_s
from portbench.metrics import op_roofline

OPS = ("repro_torch::flash_bwd",)


def read(trace, ctx):
    s, t = ctx["spec"], ctx["traffic"]
    args = (t["batch"], s["n_heads"], s["kv_heads"], t["seq"], t["seq"],
            s["head_dim"], True)
    elt = ctx["elt"]
    return op_roofline(trace, OPS, bound_s(
        flash_bwd.ops(*args), flash_bwd.nbytes(*args, elt), elt))
