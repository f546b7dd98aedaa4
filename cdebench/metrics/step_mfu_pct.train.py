"""The whole train step's model FLOPs per second over the float32 peak (%):
2 W H (1 + C) per field evaluation per row, times the evaluations the
solver needs, times 3 for forward and backward."""

from cdebench.readers import mfu


def read(summary):
    return mfu(summary, "train", 3)
