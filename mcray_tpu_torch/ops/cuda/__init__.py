"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``) and their wrappers.

Each module holds a kernel's wrapper, its plain PyTorch version and a
``launches`` counter (``march`` and ``scanconv`` also hold their backward
kernel, counted in ``launches_bwd``). A wrapper launches the kernel for CUDA
tensors and calls the plain version only for CPU tensors; anything else
raises.
"""

from . import (bvh_intersect, intersect, intersect_culled, intersect_grouped, intersect_listed,
               intersect_staged, march, postproc, scanconv)

KERNELS = (intersect, intersect_listed, intersect_culled, intersect_staged, intersect_grouped,
           bvh_intersect, march, postproc, scanconv)


#: the modules that also hold a backward kernel
BACKWARD_KERNELS = (march, scanconv)


def reset_launch_counts() -> None:
    for mod in KERNELS:
        mod.launches = 0
    for mod in BACKWARD_KERNELS:
        mod.launches_bwd = 0


def launch_counts() -> dict[str, int]:
    """Launches since the last reset, by kernel: the modules' names, and
    ``march_bwd`` and ``scanconv_bwd`` for the backward kernels."""
    def name(mod):
        return mod.__name__.rsplit(".", 1)[-1]

    counts = {name(mod): mod.launches for mod in KERNELS}
    counts.update({f"{name(mod)}_bwd": mod.launches_bwd for mod in BACKWARD_KERNELS})
    return counts
