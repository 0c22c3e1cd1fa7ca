"""Device busy ms a frame: the union of the device events' intervals over the
profiled chained calls, over their frames."""


def read(trace):
    return trace.view["busy_ms"] / trace.frames
