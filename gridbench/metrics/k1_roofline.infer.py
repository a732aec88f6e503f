"""K1's share of its roofline: the least time of the window-attention
forward at each call's shape (its products at the compute dtype's peak
against x read and y written once, ``attention_bound_ms``) over K1's
device time per forward.  K1 is found by the kernel names below."""

import torch

from gridbench.common.peaks import attention_bound_ms

LAYER = "window-attention kernels"
UNIT = "%"
MOVES = "infer_fields_per_s"
PATTERNS = [r"\bwindow_attention_fwd_kernel\b",
            r"\bwindow_attention_fwd_strips\b"]


def read(trace):
    forwards = trace.units.get("forwards", 0)
    seconds = trace.kernel_s(PATTERNS)
    if not forwards or seconds <= 0:
        return None
    dtype = getattr(torch, trace.cell["compute_dtype"])
    bound_ms = sum(attention_bound_ms(*call, dtype=dtype)[0]
                   for call in trace.cell["attention_calls"])
    return 100.0 * bound_ms * 1e-3 * forwards / seconds
