"""Device ms a frame of the trace's backward: autograd through the bounce
physics into the material table, on the timed path: the traced requests' device
events from each of the program's ``mcray_mark_trace_bwd`` marks to the next
mark, their union, over the frames (``harness/fit_stages.py``)."""

from benchmark.harness import fit_stages


def read(trace):
    return fit_stages.per_frame(trace, ("trace_bwd",))
