"""Device time of the host-to-device and device-to-host copies a serving
call: the scans and noise going up, the completions coming back."""

UNIT = "ms"


def read(trace, counters):
    if trace is None or counters.get("kind") != "serve" or not counters.get("calls"):
        return None
    seconds = sum(trace.copies.get(k, [0, 0.0])[1] for k in ("HtoD", "DtoH"))
    if seconds <= 0:
        return None
    return 1e3 * seconds / counters["calls"]
