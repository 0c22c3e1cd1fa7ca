"""Build and bind the port's CUDA kernels.

``library()`` compiles every ``mcray_tpu_torch/csrc/*.cu`` into one shared
library with a plain C interface the first time a kernel is launched, and
loads it with ``ctypes``. Each source compiles in its own ``nvcc`` process,
all started together, and one more links them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xcompiler -fPIC -Xptxas -v -I csrc -c csrc/<name>.cu -o <name>.o   (each, in parallel)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o build/mcray_tpu_torch/libmcray_<hash>.so *.o

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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
# C signatures of the entry points (the launches return cudaError_t as int and
# take the CUDA stream last; the others return what RESTYPES says)
SIGNATURES = {
    "mcray_intersect_closest": [P, I, P, I, P, P, P, P],
    "mcray_bvh_intersect": [P, I, P, P, I, I, P, P, P, P, P],
    "mcray_intersect_listed": [P, I, I, P, P, P, I, P, P, P, P, I, P, P, P, P],
    "mcray_intersect_grouped": [P, I, P, P, I, I, P, I, P, P, P],
    "mcray_intersect_culled": [P, I, P, P, I, I, P, P, P, P],
    "mcray_intersect_staged": [P, I, P, I, I, P, P, I, P, P, P, P],
    "mcray_intersect_listed_static_shared": [],
    "mcray_intersect_culled_static_shared": [],
    "mcray_intersect_staged_static_shared": [],
    "mcray_march": [P, I, I, I, I, U, U, F, F, F, F, F, F, I, F, I, I, I, F, P, P, P],
    "mcray_march_bwd": [P, P, I, I, I, I, U, U, F, F, F, F, F, I, F, I, I, I, F, P, P, P],
    "mcray_postproc": [P, I, I, I, P, I, P, I, I, P, P, P, P],
    "mcray_postproc_slab_floats": [I, I, I, I, I],
    "mcray_scan_convert": [P, I, I, I, P, I, P, P, P],
    "mcray_scan_convert_bwd": [P, P, P, P, I, I, I, P, P, P],
    "mcray_mark": [I, P],
    "mcray_keyed_draws": [P, I, P, I, I, P, P],
    "mcray_fold_in": [P, I, P, I, U, I, P, P],
    "mcray_capture_nodes": [P],
    "mcray_bounce": [P, P],
    "mcray_bounce_shared_bytes": [I, I],
}

RESTYPES = {"mcray_postproc_slab_floats": ctypes.c_longlong,
            "mcray_capture_nodes": ctypes.c_longlong}


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


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel; raise with nvcc's stderr if one fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{err}")
    return [err for _, err in outs]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has none."""
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        cu = [s for s in _sources() if s.suffix == ".cu"]
        objs = [str(tmp.with_name(f"{tmp.name}.{src.stem}.o")) for src in cu]
        compiles = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", obj]
                    for src, obj in zip(cu, objs)]
        link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *objs]
        t0 = time.perf_counter()
        try:
            logs = _run_all(compiles) + _run_all([link])
        finally:
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
        cmds = "\n".join(f"# {' '.join(c)}" for c in [*compiles, link])
        path.with_suffix(".log").write_text(
            f"{cmds}\n# {time.perf_counter() - t0:.1f} s\n{''.join(logs)}"
        )
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    return lib


def build_log() -> str:
    """nvcc's output (ptxas register and shared-memory use) of the build."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check(code: int, name: str) -> None:
    if code == 1:  # cudaErrorInvalidValue: the C entry refused its arguments, launched nothing
        raise ValueError(f"{name}: arguments the kernel does not take (CUDA error 1)")
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


#: shared memory a block may take without opting in (cudaFuncSetAttribute)
SHARED_BYTES = 48 * 1024
#: rays per block of the cluster kernels K5, K6, K7 (``GROUP`` of
#: ``csrc/intersect_common.cuh``); their plain versions group rays alike
CLUSTER_GROUP = 4


@functools.lru_cache(maxsize=None)
def static_shared(entry: str) -> int:
    """Static shared bytes of the kernel behind C entry ``entry``
    (``mcray_intersect_listed`` etc.), as ``cudaFuncGetAttributes`` reports them."""
    n = getattr(library(), f"{entry}_static_shared")()
    if n < 0:
        raise RuntimeError(f"{entry}: cudaFuncGetAttributes failed")
    return n


def require_tiles(packed, entry: str) -> None:
    """Raise unless the cluster kernel behind C entry ``entry`` (K5, K6 or
    K7) can take ``packed``'s tiles: it copies rows 0-8 of a tile into a
    two-stage ring in shared memory in 16-byte units, so ``hbm_tris`` and
    ``aabb_cluster`` must be 16-byte aligned, ``tile_t`` a multiple of 4,
    and two stages of 9 x ``tile_t`` floats, with the kernel's static shared
    memory, must fit in ``SHARED_BYTES``."""
    tiles, boxes, tile_t = packed.hbm_tris, packed.aabb_cluster, packed.tile_t
    if tiles.data_ptr() % 16 or boxes.data_ptr() % 16 or tile_t % 4:
        raise ValueError("hbm_tris and aabb_cluster must be 16-byte aligned and tile_t a "
                         "multiple of 4 (the kernels copy rows 0-8 of a tile in 16-byte units)")
    ring, static = 2 * 9 * tile_t * 4, static_shared(entry)
    if ring + static > SHARED_BYTES:
        raise ValueError(f"tile_t {tile_t}: two tiles of 9 x tile_t floats ({ring} bytes) and "
                         f"{entry}'s {static} bytes of static shared memory must fit in "
                         f"{SHARED_BYTES} bytes (tile_t <= {(SHARED_BYTES - static) // 72})")
