"""Device operations (kernels and copies) per call."""

from cdebench.readers import ops_per_call


def read(summary):
    return ops_per_call(summary, "train")
