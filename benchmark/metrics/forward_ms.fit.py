"""Device ms a frame of the fit step's forward: the six forward stages (the
keys and draws, the prepass, the closest hit, the bounce physics, the march,
the image), each from its ``mcray_mark_<stage>`` mark to the next mark, their
unions summed, over the frames (``harness/fit_stages.py``)."""

from benchmark.harness import fit_stages, stages


def read(trace):
    return fit_stages.per_frame(trace, stages.STAGES)
