"""The device's idle share of the traced window (%): 100 minus the union of
its operations' intervals over the window."""

from cdebench.readers import idle_pct


def read(summary):
    return idle_pct(summary, "infer")
