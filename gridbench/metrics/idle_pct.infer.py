"""The share of the traced window in which no operation ran on the
device: one minus the union of the profiler's device intervals over the
window."""

LAYER = "device"
UNIT = "%"
MOVES = "infer_fields_per_s"


def read(trace):
    if not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
