"""The NVIDIA H100 SXM's published peaks and the least time of a piece of work.

Copied from ``chip_smoke.py:1386-1389`` (the peaks) and ``:3381-3390``
(``bound``), so that a change to the program cannot move the yardstick.
The rates are the data sheet's at the full power limit of 700 W.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # float32 outside the tensor cores
BF16_TENSOR_FLOPS = 989e12
TF32_TENSOR_FLOPS = 495e12


def bound(bytes_moved, flops, flops_per_s=FP32_FLOPS):
    """(least seconds, what bounds it): bytes over the HBM rate against the
    operations over their type's peak rate."""
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S, flops / flops_per_s
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
