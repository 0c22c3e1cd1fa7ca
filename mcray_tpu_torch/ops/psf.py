"""Separable point-spread-function kernels (host numpy).

Copy of ``mcray_tpu/ops/psf.py:22-47`` (the reference module imports
``jax.numpy``): axial = Gaussian x cos(2 pi f x), lateral and elevation =
Gaussian (reference src/psf.h:34-92).
"""

from __future__ import annotations

import numpy as np

from ..config import SimConfig

# The reference redefines M_PI to 5 decimal places (src/psf.h:9).
_REF_PI = 3.14159


def axial_kernel_np(cfg: SimConfig) -> np.ndarray:
    res = cfg.resolution_um / 1000.0  # [mm]
    half = cfg.psf_axial_size * cfg.resolution_um / 1000.0 / 2.0
    i = np.arange(cfg.psf_axial_size, dtype=np.float32)
    x = i * res - half
    return (np.exp(-0.5 * x * x / cfg.psf_var_x)
            * np.cos(2.0 * _REF_PI * cfg.transducer_frequency * x)).astype(np.float32)


def lateral_kernel_np(cfg: SimConfig) -> np.ndarray:
    res = cfg.resolution_um / 1000.0
    half = cfg.psf_lateral_size * cfg.resolution_um / 1000.0 / 2.0
    i = np.arange(cfg.psf_lateral_size, dtype=np.float32)
    y = i * res - half
    return np.exp(-0.5 * y * y / cfg.psf_var_y).astype(np.float32)


def elevation_kernel_np(cfg: SimConfig) -> np.ndarray:
    res = cfg.resolution_um / 1000.0
    half = cfg.psf_elevation_size * cfg.resolution_um / 1000.0 / 2.0
    i = np.arange(cfg.psf_elevation_size, dtype=np.float32)
    z = i * res - half
    return np.exp(-0.5 * z * z / cfg.psf_var_z).astype(np.float32)
