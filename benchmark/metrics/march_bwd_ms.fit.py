"""Device ms a frame of the march's backward: K8 and the packed segments'
backward into the segments and the material table, on the timed path: the
traced requests' device events from each of the program's
``mcray_mark_march_bwd`` marks to the next mark, their union, over the frames
(``harness/fit_stages.py``)."""

from benchmark.harness import fit_stages


def read(trace):
    return fit_stages.per_frame(trace, ("march_bwd",))
