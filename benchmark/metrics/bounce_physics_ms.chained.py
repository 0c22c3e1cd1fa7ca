"""Device ms a frame of the bounce physics: the trace's set-up, each bounce's
rays and boundary physics (``trace_paths``), then the segments stacked, on
the timed path: the traced call's device events from each of the program's
``mcray_mark_bounce_physics`` marks to the next mark, their union, over the
frames (``harness/stages.py``)."""

from benchmark.harness import stages


def read(trace):
    ms = stages.stage_ms(trace.view["intervals"])
    return None if ms is None else ms["bounce_physics"] / trace.frames
