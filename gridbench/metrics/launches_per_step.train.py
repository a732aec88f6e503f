"""Kernel launches of the traced window (device kernels, copies and fills
left out) per train step completed in it."""

LAYER = "dispatch"
UNIT = "launches/step"
MOVES = "train_samples_per_s"


def read(trace):
    steps = trace.units.get("steps", 0)
    if not steps or not trace.kernels:
        return None
    return trace.launches() / steps
