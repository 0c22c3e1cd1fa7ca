"""Device ms a frame of the update: the mask, Adam and the clamp of the trained
entries, on the timed path: the traced requests' device events from each of the
program's ``mcray_mark_update`` marks to the next mark, their union, over the
frames (``harness/fit_stages.py``)."""

from benchmark.harness import fit_stages


def read(trace):
    return fit_stages.per_frame(trace, ("update",))
