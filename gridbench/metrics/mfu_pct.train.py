"""The train step's share of the card's peak: the forward's and
backward's operations per sample (the reference counted by
FlopCounterMode) times the samples a second of the untraced window, over
the configuration's peak."""

LAYER = "model step"
UNIT = "%"
MOVES = "train_samples_per_s"


def read(trace):
    rate = trace.rates.get("train_samples_per_s")
    if not rate:
        return None
    return 100.0 * trace.cell["flops_per_sample"] * rate / trace.cell[
        "peak_flops"]
