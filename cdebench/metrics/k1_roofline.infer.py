"""K1's share of its roofline in infer cells (%): its least time at the cell's
batch (``work/``) over its device time per call."""

from cdebench.readers import roofline


def read(summary):
    return roofline(summary, "K1", "infer")
