"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``) and their wrappers.

Each module holds a kernel's wrapper, its plain PyTorch version and a
``launches`` counter (``march`` and ``scanconv`` also hold their backward
kernel, counted in ``launches_bwd``). A wrapper launches the kernel for CUDA
tensors and calls the plain version only for CPU tensors; anything else
raises. A wrapper counts its launch when it makes it, so launches captured
into a CUDA graph are counted by whoever replays it (``add_launch_counts``;
the chained batch does).
"""

from . import (bounce, bvh_intersect, draws, intersect, intersect_culled, intersect_grouped,
               intersect_listed, intersect_staged, march, postproc, scanconv)

KERNELS = (intersect, intersect_listed, intersect_culled, intersect_staged, intersect_grouped,
           bvh_intersect, march, postproc, scanconv, draws, bounce)


#: the modules that also hold a backward kernel
BACKWARD_KERNELS = (march, scanconv)


def reset_launch_counts() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def _counters() -> dict[str, tuple]:
    """(module, attribute) of each launch counter, by kernel: the modules'
    names, and ``march_bwd`` and ``scanconv_bwd`` for the backward kernels."""
    def name(mod):
        return mod.__name__.rsplit(".", 1)[-1]

    counters = {name(mod): (mod, "launches") for mod in KERNELS}
    counters.update({f"{name(mod)}_bwd": (mod, "launches_bwd") for mod in BACKWARD_KERNELS})
    return counters


def launch_counts() -> dict[str, int]:
    """Launches since the last reset, by kernel: the modules' names, and
    ``march_bwd`` and ``scanconv_bwd`` for the backward kernels."""
    return {k: getattr(mod, attr) for k, (mod, attr) in _counters().items()}


def add_launch_counts(counts: dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``counts`` (by kernel, as ``launch_counts`` names
    them) to the counters: the launches of a CUDA graph's replays, which no
    wrapper sees (``times`` -1 takes back the launches a capture counted)."""
    counters = _counters()
    for name, n in counts.items():
        mod, attr = counters[name]
        setattr(mod, attr, getattr(mod, attr) + times * n)
