"""The march backward kernel's (K8) share of its roofline, %: its floor a
launch on the configuration's shapes (``harness/fit_roofline.py``) over its
device ms a launch in the traced requests."""

from benchmark.harness import fit_roofline


def read(trace):
    return fit_roofline.share(trace, "march_bwd_kernel", fit_roofline.march_bwd_floor_ms)
