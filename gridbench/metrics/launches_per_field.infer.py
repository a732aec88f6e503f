"""Kernel launches of the traced window (device kernels, copies and fills
left out) per field completed in it."""

LAYER = "dispatch"
UNIT = "launches/field"
MOVES = "infer_fields_per_s"


def read(trace):
    fields = trace.units.get("fields", 0)
    if not fields or not trace.kernels:
        return None
    return trace.launches() / fields
