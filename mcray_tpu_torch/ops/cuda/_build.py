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
with nvcc's stderr.

``ENTRIES`` is the one table of the C entry points: each one's ctypes
signature and, for a launch, the kernel it counts under. ``launch`` makes
every launch of a wrapper: it passes the current stream, raises on the code
the entry returns (``cudaGetLastError()`` after its launch), counts the
launch and keeps its grid. ``launch_counts``, ``add_launch_counts`` and
``last_grid`` read and add to what it counted.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "mcray_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32


class Entry(NamedTuple):
    """A C entry point: its argument types; for a launch, the kernel its
    launches count under (``launch_counts``' names) and whether it reports
    its grid (through the ``int*`` before the CUDA stream, which a launch
    takes last); its return type (a launch returns ``cudaError_t`` as int)."""

    args: list
    kernel: str | None = None
    grid: bool = False
    restype: type = ctypes.c_int


#: every C entry point of the library: the counted launches by kernel, then
#: ``mcray_mark`` (a launch counted nowhere) and the queries
ENTRIES = {
    "mcray_intersect_closest": Entry([P, I, P, I, P, P, P, P], "intersect", True),
    "mcray_intersect_listed": Entry([P, I, I, P, P, P, I, P, P, P, P, I, P, P, P, P],
                                    "intersect_listed", True),
    "mcray_intersect_culled": Entry([P, I, P, P, I, I, P, P, P, P], "intersect_culled", True),
    "mcray_intersect_staged": Entry([P, I, P, I, I, P, P, I, P, P, P, P], "intersect_staged",
                                    True),
    "mcray_intersect_grouped": Entry([P, I, P, P, I, I, P, I, P, P, P], "intersect_grouped",
                                     True),
    "mcray_bvh_intersect": Entry([P, I, P, P, I, I, P, P, P, P, P], "bvh_intersect", True),
    "mcray_march": Entry([P, I, I, I, I, U, U, F, F, F, F, F, F, I, F, I, I, I, F, P, P, P],
                         "march", True),
    "mcray_march_bwd": Entry([P, P, I, I, I, I, U, U, F, F, F, F, F, I, F, I, I, I, F, P, P, P],
                             "march_bwd", True),
    "mcray_postproc": Entry([P, I, I, I, P, I, P, I, I, P, P, P, P], "postproc", True),
    "mcray_scan_convert": Entry([P, I, I, I, P, I, P, P, P], "scanconv", True),
    "mcray_scan_convert_bwd": Entry([P, P, P, P, I, I, I, P, P, P], "scanconv_bwd", True),
    "mcray_keyed_draws": Entry([P, I, P, I, I, P, P], "draws"),
    "mcray_fold_in": Entry([P, I, P, I, U, I, P, P], "draws"),
    "mcray_bounce": Entry([P, P], "bounce"),
    "mcray_bounce_bwd": Entry([P, P], "bounce_bwd"),
    "mcray_mark": Entry([I, P]),
    "mcray_intersect_listed_static_shared": Entry([]),
    "mcray_intersect_culled_static_shared": Entry([]),
    "mcray_intersect_staged_static_shared": Entry([]),
    "mcray_postproc_slab_floats": Entry([I, I, I, I, I], restype=ctypes.c_longlong),
    "mcray_bounce_shared_bytes": Entry([I, I]),
    "mcray_capture_nodes": Entry([P], restype=ctypes.c_longlong),
}

#: the kernels whose launches ``launch_counts`` counts, in ``ENTRIES``' order
COUNTED = tuple(dict.fromkeys(e.kernel for e in ENTRIES.values() if e.kernel))


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
    for name, entry in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = entry.args, entry.restype
    return lib


def build_log() -> str:
    """nvcc's output (ptxas register and shared-memory use) of the build."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(code: int, name: str) -> None:
    if code == 1:  # cudaErrorInvalidValue: the C entry refused its arguments, launched nothing
        raise ValueError(f"{name}: arguments the kernel does not take (CUDA error 1)")
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


#: launches run since the last reset, and the grid of the latest launch, by kernel
_launches = dict.fromkeys(COUNTED, 0)
_grids = dict.fromkeys(COUNTED, 0)
#: the launches of the capture that ``tallied`` holds open, by kernel
_tally = None


def launch(entry: str, *args, device) -> None:
    """Launch C entry ``entry`` with ``args`` on ``device``'s current
    stream: an ``int*`` for the grid follows them where the entry reports
    one, then the stream. Raises on the entry's code (``check``), then
    counts the launch under its kernel: in the open capture's tally where
    the current stream is capturing (``tallied``; without one it counts
    nowhere, since a captured launch has not run), else in the totals
    (``launch_counts``); keeps the grid (``last_grid``)."""
    spec = ENTRIES[entry]
    blocks = ctypes.c_int(0)
    grid = (ctypes.byref(blocks),) if spec.grid else ()
    code = getattr(library(), entry)(*args, *grid, torch.cuda.current_stream(device).cuda_stream)
    check(code, entry)
    if spec.kernel is None:
        return
    if spec.grid:
        _grids[spec.kernel] = blocks.value
    if not torch.cuda.is_current_stream_capturing():
        _launches[spec.kernel] += 1
    elif _tally is not None:
        _tally[spec.kernel] += 1


@contextlib.contextmanager
def tallied():
    """Yield the tally (by kernel) that the launches captured inside go to,
    in place of the totals."""
    global _tally
    outer, _tally = _tally, collections.Counter()
    try:
        yield _tally
    finally:
        _tally = outer


def launch_counts() -> dict[str, int]:
    """Launches run since the last reset, by kernel: every kernel of
    ``COUNTED``, 0 included."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for kernel in _launches:
        _launches[kernel] = 0


def add_launch_counts(counts: dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``counts`` (by kernel, as ``launch_counts`` names
    them) to the totals: the launches of a CUDA graph's replays, which no
    wrapper sees. Raises ``KeyError`` on a name that is no kernel's."""
    unknown = set(counts) - set(_launches)
    if unknown:
        raise KeyError(f"no launch counter for {sorted(unknown)}")
    for kernel, n in counts.items():
        _launches[kernel] += times * n


def last_grid(kernel: str) -> int:
    """The grid (blocks) of ``kernel``'s latest launch, as its C entry
    reported it; 0 before the first."""
    return _grids[kernel]


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
