"""Device ms a frame of the closest hit, each bounce: the listed kernel (K5)
and its winner tail (``clusters.winner_hits``), on the timed path: the
traced call's device events from each of the program's
``mcray_mark_closest_hit`` marks to the next mark, their union, over the
frames (``harness/stages.py``)."""

from benchmark.harness import stages


def read(trace):
    ms = stages.stage_ms(trace.view["intervals"])
    return None if ms is None else ms["closest_hit"] / trace.frames
