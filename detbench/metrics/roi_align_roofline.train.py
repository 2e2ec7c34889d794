"""RoIAlign's forward and backward kernels' share of their roofline in a train step."""
from core import readers


def read(tr):
    return readers.roofline_share(tr, "roi_align_fwd", "roi_align_bwd")
