"""Device ms a frame of the march, postproc and scan-conversion kernels (K2,
K3, K4)."""


def read(trace):
    return trace.kernel_ms("march_kernel", "postproc_kernel", "scan_convert_kernel") / trace.frames
