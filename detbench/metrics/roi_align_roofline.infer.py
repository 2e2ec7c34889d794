"""RoIAlign's forward kernel's share of its roofline in inference."""
from core import readers


def read(tr):
    return readers.roofline_share(tr, "roi_align_fwd")
