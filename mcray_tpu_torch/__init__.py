"""mcray_tpu_torch — the PyTorch + CUDA port of mcray_tpu.

The JAX package ``mcray_tpu`` is the reference. This package renders the
same frame (trace -> march -> PSF + envelope -> scan conversion) with plain
PyTorch on the CPU and with hand-written CUDA kernels for Hopper
(``csrc/*.cu``, bound through ``ops/cuda``) on an NVIDIA GPU. It imports
``torch`` and never ``jax``, and nothing of ``mcray_tpu``: it keeps its own
copies of the config, the scene loader/OBJ/primitives, the native bridge and
the image IO.
"""

from .config import DEFAULT_CONFIG, SimConfig, small_test_config, validate

__version__ = "0.1.0"

__all__ = ["SimConfig", "DEFAULT_CONFIG", "small_test_config", "validate", "__version__"]
