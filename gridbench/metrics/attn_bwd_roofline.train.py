"""The attention backward's share of its roofline: the least time of its
own products (no recompute of the forward, both weight gradients
included; ``attn_bwd_bound_ms``) at each call's shape per step, over the
device time per step of K3, K3-w and their reductions, found by the
kernel names below.  It reads the same work if the kernels are merged or
split, as long as the names stay."""

from gridbench.common.peaks import attn_bwd_bound_ms

LAYER = "window-attention kernels"
UNIT = "%"
MOVES = "train_samples_per_s"
PATTERNS = [r"\bwindow_attention_bwd_kernel\b", r"\bsum_slots_kernel\b",
            r"\bwgrad_kernel\b", r"\bsum_chunks_kernel\b"]


def read(trace):
    steps = trace.units.get("steps", 0)
    seconds = trace.kernel_s(PATTERNS)
    if not steps or seconds <= 0:
        return None
    bound_ms = sum(attn_bwd_bound_ms(*call)[0]
                   for call in trace.cell["attention_calls"])
    return 100.0 * bound_ms * 1e-3 * steps / seconds
