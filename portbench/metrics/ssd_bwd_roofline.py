"""The SSD scan backward's share of its bound: the calls of
``repro_torch::ssd_scan_bwd`` over their device time, each call's bound
from ``cost/ssd_bwd.py`` (float32 operands, B and C shared by the heads)
at the cell's shapes."""
from portbench.cost import ssd_bwd
from portbench.cost.peaks import bound_s
from portbench.metrics import op_roofline

OPS = ("repro_torch::ssd_scan_bwd",)


def read(trace, ctx):
    s, t = ctx["spec"], ctx["traffic"]
    di = s["ssm_expand"] * s["d_model"]
    p, n = s["ssm_head_dim"], s["ssm_state"]
    nb, nh, seq = t["batch"], di // p, t["seq"]
    return op_roofline(trace, OPS, bound_s(
        ssd_bwd.ops(nb, nh, seq, n, p, s["ssd_chunk"], True),
        ssd_bwd.nbytes(nb, nh, seq, n, p, True), 4))
