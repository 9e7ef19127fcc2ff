"""K2's share of its roofline in the decode loop, in %: each launch's
bound time at its cache position over the launches' device time in the
trace."""
from plexbench import readers


def read(rec):
    return readers.k2_roofline(rec)
