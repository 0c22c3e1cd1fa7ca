"""The measured CPU baseline: the sequential C++ re-implementation of the
reference's frame (``native/ref_baseline.cpp``) on the host it runs on.

Port of ``scripts/ref_baseline_bench.py``'s driver. The C++ frame traces
with a BVH closest hit, marches the segments through a materialised
texture table, convolves with the uncentered PSF, takes the peak-lerp
envelope and scan-converts, single-threaded, from the same compiled scene,
probe layout, PSF taps and scan maps that the port renders from; its random
stream is its own (``std::mt19937``), so it matches the port's frames in
distribution only (the reference's ``tests/test_ref_baseline.py``). It
times the host, not the card: ``bench_torch.py`` sets its frame against
the port's, wall against wall.

``build`` compiles ``native/mcray_native.cpp`` and ``native/ref_baseline.cpp``
with ``native/Makefile``'s compiler and flags (read from the Makefile) into
a library named by a hash of the sources and flags, in
``build/mcray_tpu_torch/`` (git ignores it) unless told another directory.
Nothing is written under ``native/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

from ..ops import imaging, psf
from ..probe.transducer import element_layout

ROOT = Path(__file__).resolve().parents[2]
NATIVE = ROOT / "native"
SOURCES = ("mcray_native.cpp", "ref_baseline.cpp")
BUILD_DIR = ROOT / "build" / "mcray_tpu_torch"

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int32)


def makefile_flags() -> tuple[str, list[str]]:
    """(compiler, flags) as ``native/Makefile`` sets ``CXX`` and ``CXXFLAGS``."""
    text = (NATIVE / "Makefile").read_text()

    def var(name: str) -> str:
        found = re.search(rf"^{name}\s*\??=\s*(.*)$", text, re.MULTILINE)
        if found is None:
            raise RuntimeError(f"native/Makefile sets no {name}")
        return found.group(1).strip()

    return var("CXX"), var("CXXFLAGS").split()


def build(out_dir: Path | str = BUILD_DIR) -> Path:
    """The baseline library in ``out_dir``, compiled first if this hash of
    the sources and flags has none there; raises with the compiler's
    output if the build fails."""
    cxx, flags = makefile_flags()
    h = hashlib.sha256(" ".join([cxx, *flags]).encode())
    for name in SOURCES:
        h.update((NATIVE / name).read_bytes())
    out_dir = Path(out_dir)
    path = out_dir / f"libmcray_ref_{h.hexdigest()[:16]}.so"
    if path.exists():
        return path
    compiler = shutil.which(cxx)
    if compiler is None:
        raise RuntimeError(f"{cxx} not found: the C++ baseline needs a C++ compiler")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([compiler, *flags, "-shared", "-o", str(tmp),
                           *(str(NATIVE / name) for name in SOURCES)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_FP)


def run(pack, cfg, frames: int = 5, seed: int = 0, lib_path: Path | str | None = None) -> dict:
    """Time ``frames`` C++ frames of ``pack`` at ``cfg`` on the host (after
    one warm-up frame; the BVH is built once, as the reference builds it at
    scene set-up). ``cfg``'s volume is materialised as two (V, V, V) normal
    tables drawn from ``seed`` (the C++ frame's texture mode). Returns the
    wall ms a frame, rays/s (``cfg``'s path-bounce queries over that), the
    stages' ms, the C++ counters and the last frame's B-mode."""
    lib = ctypes.CDLL(str(lib_path or build()))
    lib.mcray_ref_prepare.restype = ctypes.c_void_p
    lib.mcray_ref_free.argtypes = [ctypes.c_void_p]
    lib.mcray_ref_frame.restype = ctypes.c_int

    import torch

    positions, directions = element_layout(torch.as_tensor(pack.transducer_position),
                                           torch.as_tensor(pack.transducer_angles), cfg)
    positions = np.ascontiguousarray(positions.numpy(), np.float32)
    directions = np.ascontiguousarray(directions.numpy(), np.float32)
    gen = np.random.default_rng(seed)
    v = cfg.volume_size
    vol_noise = gen.standard_normal((v, v, v), np.float32)
    vol_prob = gen.standard_normal((v, v, v), np.float32)
    ax, lat = psf.axial_kernel_np(cfg), psf.lateral_kernel_np(cfg)
    map_row, map_col = (np.ascontiguousarray(m, np.float32)
                        for m in imaging.scan_conversion_maps(cfg))
    tris = np.ascontiguousarray(pack.tris, np.float32)
    tri_mid = np.ascontiguousarray(pack.tri_mesh_id, np.int32)
    m_in = np.ascontiguousarray(pack.mesh_mat_inside, np.int32)
    m_out = np.ascontiguousarray(pack.mesh_mat_outside, np.int32)
    vasc = np.ascontiguousarray(pack.mesh_is_vascular, np.uint8)
    mats = np.ascontiguousarray(pack.materials, np.float32)
    spacing = np.ascontiguousarray(pack.spacing, np.float32)
    bmode = np.zeros((cfg.bmode_rows, cfg.bmode_cols), np.float32)
    rf_raw = np.zeros((cfg.rf_rows, cfg.rf_cols), np.float32)
    stage_ms = np.zeros(4, np.float64)
    counters = np.zeros(3, np.int64)

    bvh = lib.mcray_ref_prepare(_fp(tris), ctypes.c_int(pack.n_triangles))
    c = ctypes

    def frame(frame_seed: int) -> None:
        rc = lib.mcray_ref_frame(
            c.c_void_p(bvh), _fp(tris), c.c_int(pack.n_triangles), tri_mid.ctypes.data_as(_IP),
            m_in.ctypes.data_as(_IP), m_out.ctypes.data_as(_IP),
            vasc.ctypes.data_as(c.POINTER(c.c_uint8)), _fp(mats), c.c_int(pack.n_materials),
            _fp(positions), _fp(directions), c.c_int(cfg.transducer_elements),
            c.c_int(cfg.samples_per_element), c.c_int(cfg.max_depth),
            c.c_int(pack.starting_material), _fp(spacing), _fp(vol_noise), _fp(vol_prob),
            c.c_int(v), c.c_float(cfg.resolution_um / 1000.0), c.c_float(cfg.transducer_frequency),
            c.c_float(cfg.speed_of_sound), c.c_float(float(cfg.max_travel_time_us)),
            c.c_float(cfg.axial_resolution_mm), c.c_int(cfg.axial_resolution_um),
            c.c_float(cfg.intensity_epsilon), c.c_float(cfg.ray_start_offset),
            _fp(ax), c.c_int(ax.shape[0]), _fp(lat), c.c_int(lat.shape[0]),
            _fp(map_row), _fp(map_col), c.c_int(cfg.bmode_rows), c.c_int(cfg.bmode_cols),
            c.c_int(cfg.rf_rows), c.c_uint64(frame_seed), _fp(bmode), _fp(rf_raw),
            stage_ms.ctypes.data_as(c.POINTER(c.c_double)),
            counters.ctypes.data_as(c.POINTER(c.c_longlong)),
        )
        if rc != 0:
            raise RuntimeError(f"mcray_ref_frame returned {rc}")

    try:
        frame(seed)  # warm-up: page-in
        totals = np.zeros(4, np.float64)
        t0 = time.perf_counter()
        for i in range(frames):
            frame(seed + 1 + i)
            totals += stage_ms
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    finally:
        lib.mcray_ref_free(c.c_void_p(bvh))
    per = totals / frames
    rays = cfg.transducer_elements * cfg.samples_per_element * cfg.max_depth
    return {
        "frame_ms": wall_ms, "rays_per_s": rays / (wall_ms / 1e3), "frames": frames,
        "triangles": pack.n_triangles,
        "stage_ms": dict(zip(("trace", "march", "conv_envelope", "scan_convert"), per.tolist())),
        "ray_queries": int(counters[0]), "collisions": int(counters[1]),
        "segments": int(counters[2]), "bmode": bmode.copy(),
    }
