"""The SSD scan forward's share of its bound: the calls of
``repro_torch::ssd_scan`` and ``ssd_scan_state`` over their device time,
each call's bound from ``cost/ssd_fwd.py`` (float32 operands, B and C
shared by the heads) at the cell's shapes."""
from portbench.cost import ssd_fwd
from portbench.cost.peaks import bound_s
from portbench.metrics import op_roofline

OPS = ("repro_torch::ssd_scan", "repro_torch::ssd_scan_state")


def read(trace, ctx):
    s, t = ctx["spec"], ctx["traffic"]
    di = s["ssm_expand"] * s["d_model"]
    p, n = s["ssm_head_dim"], s["ssm_state"]
    nb, nh, seq = t["batch"], di // p, t["seq"]
    return op_roofline(trace, OPS, bound_s(
        ssd_fwd.ops(nb, nh, seq, n, p, s["ssd_chunk"], True),
        ssd_fwd.nbytes(nb, nh, seq, n, p, True), 4))
