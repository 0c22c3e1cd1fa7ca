"""Device ms a frame of the keyed draws: the step's frame keys (threefry) and
the frames' bounce draws (``path_draws``), on the timed path: the traced
call's device events from each of the program's ``mcray_mark_draws`` marks
to the next mark, their union, over the frames (``harness/stages.py``)."""

from benchmark.harness import stages


def read(trace):
    ms = stages.stage_ms(trace.view["intervals"])
    return None if ms is None else ms["draws"] / trace.frames
