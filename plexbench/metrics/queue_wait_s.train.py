"""Median time a training op waited: submit to resolve, less its execution
(the WPG exec log) and the switch that loaded its job (the switch log)."""
from plexbench import readers


def read(rec):
    return readers.queue_wait(rec)
