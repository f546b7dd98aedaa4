"""The median host ms inside the entry call, in the benchmark's span
around it."""

from cdebench.readers import host_call_ms


def read(summary):
    return host_call_ms(summary, "infer")
