"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``) and their wrappers.

Each module holds one kernel's wrapper, its plain PyTorch version and a
``launches`` counter. A wrapper launches the kernel for CUDA tensors and
calls the plain version only for CPU tensors; anything else raises.
"""

from . import (intersect, intersect_culled, intersect_listed, intersect_staged, march, postproc,
               scanconv)

KERNELS = (intersect, intersect_listed, intersect_culled, intersect_staged, march, postproc,
           scanconv)


def reset_launch_counts() -> None:
    for mod in KERNELS:
        mod.launches = 0


def launch_counts() -> dict[str, int]:
    return {mod.__name__.rsplit(".", 1)[-1]: mod.launches for mod in KERNELS}
