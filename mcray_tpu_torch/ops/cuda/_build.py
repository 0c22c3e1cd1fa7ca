"""Build and bind the port's CUDA kernels.

``library()`` compiles every ``mcray_tpu_torch/csrc/*.cu`` into one shared
library with a plain C interface the first time a kernel is launched, and
loads it with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o build/mcray_tpu_torch/libmcray_<hash>.so csrc/*.cu

``-fmad=false`` keeps every multiply and add separately rounded, as plain
PyTorch on CUDA computes them (one op per kernel, no contraction), so the
kernels' discrete outputs (closest-hit index, matched march rows) can equal
their plain versions exactly. No fast-math flag is passed.

The library is named by a hash of the sources and flags and lives in
``build/mcray_tpu_torch/`` beside the package (git ignores it), so an edited
source rebuilds and an unchanged one loads at once. A failed build raises
with nvcc's stderr. Each C entry point returns ``cudaGetLastError()`` after
its launch; ``check`` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "mcray_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

P, I, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
# C signatures of the entry points (all return cudaError_t as int; the last
# argument is the CUDA stream)
SIGNATURES = {
    "mcray_intersect_closest": [P, I, P, I, P, P, P],
    "mcray_march": [P, I, I, I, I, U, U, F, F, F, F, F, F, I, F, P, P],
    "mcray_postproc": [P, I, I, P, I, P, I, I, P, P],
    "mcray_scan_convert": [P, I, I, P, I, I, I, P, P],
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmcray_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has none."""
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cu = [str(s) for s in _sources() if s.suffix == ".cu"]
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), *cu]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
            )
        path.with_suffix(".log").write_text(
            f"# {' '.join(cmd)}\n# {time.perf_counter() - t0:.1f} s\n{proc.stderr}"
        )
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_log() -> str:
    """nvcc's output (ptxas register and shared-memory use) of the build."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def require(t, name: str, dtype, shape: tuple | None = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and ``shape``)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
