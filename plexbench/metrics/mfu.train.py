"""Model FLOPs of the training ops completed in the snapped window (2NT a
FORWARD, 6NT an UPDATE_ACTOR, attention included, recompute not) over its
wall seconds at 989 TFLOP/s, in %."""
from plexbench import readers


def read(rec):
    return readers.mfu(rec)
