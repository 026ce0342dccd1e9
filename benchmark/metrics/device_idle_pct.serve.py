"""The share of the traced window in which no operation ran on the card
(kernels, copies and fills, their union), in the serve cells."""

UNIT = "%"


def read(trace, counters):
    if trace is None or trace.busy_s <= 0 or counters.get("kind") != "serve" or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
