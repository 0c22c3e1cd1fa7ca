"""Device ms a frame of the image: K3 (PSF and envelope), K4 (scan conversion)
and the clamp, then the chain's carry, on the timed path: the traced call's
device events from each of the program's ``mcray_mark_image`` marks to the
next mark, their union, over the frames (``harness/stages.py``)."""

from benchmark.harness import stages


def read(trace):
    ms = stages.stage_ms(trace.view["intervals"])
    return None if ms is None else ms["image"] / trace.frames
