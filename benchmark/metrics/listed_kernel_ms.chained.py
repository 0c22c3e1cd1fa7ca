"""Device ms a frame of the listed closest-hit kernel (K5)."""


def read(trace):
    return trace.kernel_ms("intersect_listed_kernel") / trace.frames
