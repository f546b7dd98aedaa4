"""Device ms per call in every kernel and copy that is neither K1 nor K2:
the optimizer, the loss, casts, the control and autograd's glue."""

from cdebench.readers import other_device_ms


def read(summary):
    return other_device_ms(summary, "infer")
