"""What the per-layer metrics' readers share: sums over the traced window.

A fused kernel's device operations are those whose names match the
patterns that its solver's ``work/<solver>.py`` gives with its least times
(``summary["work"]["kernels"][<kernel>]["names"]``)."""

import re
import statistics

from cdebench.peaks import FP32_FLOPS


def kernel_patterns(summary):
    """{kernel: compiled pattern} of the cell's fused kernels."""
    return {k: re.compile("|".join(rf"\b{n}\b" for n in work["names"]))
            for k, work in summary["work"]["kernels"].items()}


def device_seconds(summary, pattern):
    return sum(e - s for name, s, e in summary["device"] if pattern.search(name)) / 1e6


def roofline(summary, kernel, mode):
    """The kernel's least time over its device time, in %, both per call;
    forward and backward in training, forward alone in inference."""
    work = summary["work"]["kernels"].get(kernel)
    if summary["mode"] != mode or work is None:
        return None
    seconds = device_seconds(summary, kernel_patterns(summary)[kernel]) / summary["calls"]
    if seconds <= 0:
        return None
    least = work["fwd_s"] + (work["bwd_s"] if mode == "train" else 0.0)
    return 100.0 * least / seconds


def mfu(summary, mode, passes):
    """Model FLOPs of every call in the window (forward times ``passes``)
    over the window's seconds, over the float32 peak, in %."""
    if summary["mode"] != mode:
        return None
    flops = passes * summary["work"]["model_flops_fwd"] * summary["calls"]
    return 100.0 * flops / summary["window_s"] / FP32_FLOPS


def idle_pct(summary, mode):
    if summary["mode"] != mode:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])


def other_device_ms(summary, mode):
    """Device ms per call in every operation that is none of the cell's fused
    kernels."""
    if summary["mode"] != mode:
        return None
    patterns = kernel_patterns(summary).values()
    total = sum(e - s for name, s, e in summary["device"]
                if not any(p.search(name) for p in patterns))
    return total / 1e3 / summary["calls"]


def ops_per_call(summary, mode):
    if summary["mode"] != mode:
        return None
    return len(summary["device"]) / summary["calls"]


def host_call_ms(summary, mode):
    if summary["mode"] != mode or not summary["spans_s"]:
        return None
    return 1e3 * statistics.median(summary["spans_s"])
