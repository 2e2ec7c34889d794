"""The share of the traced inference batches' host time in which no operation ran on the device."""
from core import readers


def read(tr):
    return readers.idle_share(tr)
