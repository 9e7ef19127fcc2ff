"""Mean seconds of a context switch on the training group: the switch
log's t_offload + t_load per change of job (the entries that moved
bytes)."""
from plexbench import readers


def read(rec):
    return readers.mean_switch(rec)
