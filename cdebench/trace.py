"""The traced window: ``torch.profiler`` over every call, and its summary.

The summary is what each per-layer metric's reader reads
(``metrics/<name>.py``): the device's operations (kernels and copies) with
their seconds, the union of their intervals (the busy time; the arithmetic
of ``profile_calls``, ``chip_smoke.py:922-958``), the benchmark's own spans
around each entry call, and the idle gaps labelled by what the host was
doing.
"""

import bisect
import collections
import contextlib

SPAN = "cdebench.call"


class NoDeviceEvents(RuntimeError):
    pass


class Tracer:
    """A profiler over the window when ``enabled``; ``span()`` marks one call."""

    def __init__(self, enabled):
        self.enabled = enabled
        self.prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def span(self):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(SPAN)

    def summary(self):
        """{"device": [(name, start_us, end_us)], "busy_s", "spans_s": [...],
        "idle": {label: seconds}}; raises NoDeviceEvents if no operation ran
        on the device."""
        from torch.autograd import DeviceType

        events = self.prof.events()
        # Spans (the benchmark's, the optimizer's) also show on the device's
        # timeline as user annotations; they are no device operations.
        device = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                        if e.device_type == DeviceType.CUDA and e.name != SPAN
                        and not getattr(e, "is_user_annotation", False))
        if not device:
            raise NoDeviceEvents("the profiler recorded no device operation in the window")
        host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                      if e.device_type == DeviceType.CPU)
        spans = [(s, e) for s, e, name in host if name == SPAN]
        ops = [h for h in host if h[2] != SPAN]
        return {"device": [(name, s, e) for s, e, name in device],
                "busy_s": union_us(device) / 1e6,
                "spans_s": [(e - s) / 1e6 for s, e in spans],
                "idle": idle_by_host(device, ops, spans)}


def union_us(intervals):
    """The length of the union of (start, end, ...) intervals sorted by start."""
    busy, reach = 0.0, float("-inf")
    for start, end, *_ in intervals:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return busy


def idle_by_host(device, ops, spans, look_back=256):
    """Seconds of device idle between the first and the last device operation,
    by what the host was doing when each gap began: the innermost host
    operation open then, else the benchmark's span ("in call"), else
    "between calls"."""
    starts = [s for s, _, _ in ops]
    span_starts = [s for s, _ in spans]
    idle = collections.Counter()
    reach = float("-inf")
    for start, end, _ in device:
        if reach > float("-inf") and start > reach:
            idle[_label(reach, ops, starts, spans, span_starts, look_back)] += (start - reach) / 1e6
        reach = max(reach, end)
    return dict(idle)


def _label(at, ops, starts, spans, span_starts, look_back):
    i = bisect.bisect_right(starts, at) - 1
    for j in range(i, max(i - look_back, -1), -1):
        if ops[j][1] >= at:
            return ops[j][2]
    k = bisect.bisect_right(span_starts, at) - 1
    if k >= 0 and spans[k][1] >= at:
        return "in call"
    return "between calls"
