"""Device ms a frame of the loss and the image's backward: the loss, the
clamp's backward, K9 (the scan conversion's) and the postproc's (plain PyTorch
autograd), on the timed path: the traced requests' device events from each of
the program's ``mcray_mark_image_bwd`` marks to the next mark, their union,
over the frames (``harness/fit_stages.py``)."""

from benchmark.harness import fit_stages


def read(trace):
    return fit_stages.per_frame(trace, ("image_bwd",))
