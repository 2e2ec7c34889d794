"""Kernel launches a train step, from the traced stretch's device records."""
from core import readers


def read(tr):
    return readers.launches_per_step(tr)
