"""K1's share of its roofline in the training ops (the forward and its
recompute), in %: the launches' bound time from their shape over their
device time in the trace."""
from plexbench import readers


def read(rec):
    return readers.k1_roofline(rec)
