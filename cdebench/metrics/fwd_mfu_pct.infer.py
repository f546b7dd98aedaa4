"""The whole forward pass's model FLOPs per second over the float32 peak (%)."""

from cdebench.readers import mfu


def read(summary):
    return mfu(summary, "infer", 1)
