"""The train step's share of the chip's peak: the reference's forward and backward FLOPs an image × images/s over the peak of the step's compute dtype."""
from core import readers


def read(tr):
    return readers.step_mfu(tr)
