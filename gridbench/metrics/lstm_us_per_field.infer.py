"""Device time of the recurrence per field of the traced window: the
device operations, copies included, that the program's ``grid.lstm``
spans (each station and grid LSTM cell step) own.  Without those spans it reads nothing."""

LAYER = "recurrence"
UNIT = "us/field"
MOVES = "infer_fields_per_s"
SPAN = "grid.lstm"


def read(trace):
    fields = trace.units.get("fields", 0)
    seconds = sum(sec for path, (sec, _) in trace.cell.get("spans", {}).items()
                  if path.rsplit("/", 1)[-1] == SPAN)
    if not fields or seconds <= 0:
        return None
    return 1e6 * seconds / fields
