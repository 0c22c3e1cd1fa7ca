"""The frame's floor (the frozen stage floors, counted on the reference's own
trace of the checked frames) as a share of the device's busy ms a frame."""


def read(trace):
    floor = trace.floor_ms_per_frame
    if floor is None or trace.view["busy_ms"] <= 0:
        return None
    return 100.0 * floor / (trace.view["busy_ms"] / trace.frames)
