"""Share of the traced stretch of a rollout window in which no kernel,
copy or set ran on the card, in %."""
from plexbench import readers


def read(rec):
    return readers.idle_share(rec)
