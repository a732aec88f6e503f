"""The joint attention's share of its roofline: the least time of the
joint attentions of a forward (their products, the in-projection, scores,
P.v and out-projection over B x n tokens, at the configuration's peak,
against their tokens read and written once; ``joint_bound_ms``) over the
device time a forward of the operations that the program's
``grid.joint_attn`` spans own, the copy that ``masked_fill`` makes of the
score map among them.  Without those spans, or without a joint attention
that the program counted, it reads nothing."""

import torch

from gridbench.common.joint_bound import joint_bound_ms

LAYER = "joint attention"
UNIT = "%"
MOVES = "infer_fields_per_s"
SPAN = "grid.joint_attn"


def read(trace):
    forwards = trace.units.get("forwards", 0)
    seconds = sum(sec for path, (sec, _) in trace.cell.get("spans", {}).items()
                  if path.rsplit("/", 1)[-1] == SPAN)
    shape = trace.cell.get("joint_attn")
    if not forwards or seconds <= 0 or not shape:
        return None
    b, n, e, steps = shape
    item = torch.finfo(getattr(torch, trace.cell["compute_dtype"])).bits // 8
    bound_ms = steps * joint_bound_ms(b, n, e, item,
                                      trace.cell["peak_flops"])[0]
    return 100.0 * bound_ms * 1e-3 * forwards / seconds
