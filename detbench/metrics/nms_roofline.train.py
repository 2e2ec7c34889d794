"""The NMS kernel's share of its roofline in a train step (the RPN's proposals)."""
from core import readers


def read(tr):
    return readers.roofline_share(tr, "nms")
