"""Model FLOPs of the GENERATEs completed in the snapped window (2NT the
prefill and each decode token, attention over the live keys included) over
its wall seconds at 989 TFLOP/s, in %."""
from plexbench import readers


def read(rec):
    return readers.mfu(rec)
