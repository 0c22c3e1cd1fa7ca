"""Device ms a frame of the closest hit's dense prepass, each bounce: the rays
padded into packets and each packet's cluster list (``clusters.pad_rays``,
``packet_cluster_lists``), on the timed path: the traced call's device
events from each of the program's ``mcray_mark_prepass`` marks to the next
mark, their union, over the frames (``harness/stages.py``)."""

from benchmark.harness import stages


def read(trace):
    ms = stages.stage_ms(trace.view["intervals"])
    return None if ms is None else ms["prepass"] / trace.frames
