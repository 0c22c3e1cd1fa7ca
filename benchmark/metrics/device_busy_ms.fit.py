"""Device busy ms a frame of the fit: the union of the device events' intervals
over the profiled fit requests, over the frames they rendered and
differentiated."""


def read(trace):
    return trace.view["busy_ms"] / trace.frames
