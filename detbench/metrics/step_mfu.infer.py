"""Inference's share of the chip's peak: the reference's forward FLOPs an image × images/s over the f32 peak."""
from core import readers


def read(tr):
    return readers.step_mfu(tr)
