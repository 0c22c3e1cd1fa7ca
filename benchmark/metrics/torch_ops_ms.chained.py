"""Device ms a frame in events that are none of the program's hand-written
kernels (the frozen kernel-name table): the plain PyTorch work of the keyed
draws, the trace's physics and the closest hit's dense prepass."""


def read(trace):
    ms = sum(v for name, v in trace.view["by_name"].items()
             if not any(k in name for k in trace.kernel_names))
    return ms / trace.frames
