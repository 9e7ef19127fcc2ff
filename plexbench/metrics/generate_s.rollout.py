"""Mean seconds of a GENERATE's execution (the WPG exec log: after the
device has finished)."""
from plexbench import readers


def read(rec):
    return readers.mean_exec(rec, "generate")
