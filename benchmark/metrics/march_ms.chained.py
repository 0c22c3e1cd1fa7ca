"""Device ms a frame of the march: the segments packed (``pack_segments``) and
K2, then the RF image laid out by frame, on the timed path: the traced
call's device events from each of the program's ``mcray_mark_march`` marks
to the next mark, their union, over the frames (``harness/stages.py``)."""

from benchmark.harness import stages


def read(trace):
    ms = stages.stage_ms(trace.view["intervals"])
    return None if ms is None else ms["march"] / trace.frames
