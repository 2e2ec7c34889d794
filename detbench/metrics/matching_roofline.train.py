"""The dynamic-k matching kernel's share of its roofline in a train step."""
from core import readers


def read(tr):
    return readers.roofline_share(tr, "matching")
