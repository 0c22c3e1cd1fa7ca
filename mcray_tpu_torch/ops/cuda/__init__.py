"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``) and their wrappers.

Each module holds a kernel's wrapper and its plain PyTorch version
(``march`` and ``scanconv`` also their backward kernel's). A wrapper
launches the kernel for CUDA tensors and calls the plain version only for
CPU tensors; anything else raises. Every launch goes through
``_build.launch``, which counts it by kernel: ``launch_counts`` reads the
counts, ``last_grid`` a kernel's latest grid. Launches captured into a CUDA
graph count in the capture's tally, not as run; whoever replays the graph
adds them (``add_launch_counts``; ``models/graph_step.py`` does).
"""

from ._build import add_launch_counts, last_grid, launch_counts, reset_launch_counts

__all__ = ["add_launch_counts", "last_grid", "launch_counts", "reset_launch_counts"]
