"""Host ms a frame inside ``CUDAGraph.replay()``: the program's
``chained.replay`` spans of the calls made before the traced one (the
warm-up calls, untouched by any profiler), over the frames they rendered
(the spans' ``units``). The host's pace of launching the step graph, beside
the device's ``device_busy_ms.chained``."""

from benchmark.harness import stages


def read(trace):
    got = stages.records()
    replays = None if got is None else stages.unprofiled_replays(got[0])
    frames = sum(s.units for s in replays or ())
    if not frames:
        return None
    return sum(s.end_ns - s.start_ns for s in replays) / 1e6 / frames
