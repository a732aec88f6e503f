"""The forward's share of the card's peak: the model's operations per
field (the reference counted by FlopCounterMode) times the fields a second
of the untraced window, over the configuration's peak."""

LAYER = "model step"
UNIT = "%"
MOVES = "infer_fields_per_s"


def read(trace):
    rate = trace.rates.get("infer_fields_per_s")
    if not rate:
        return None
    return 100.0 * trace.cell["flops_per_field"] * rate / trace.cell[
        "peak_flops"]
