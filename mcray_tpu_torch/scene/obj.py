"""Wavefront OBJ loading to packed numpy arrays.

Replaces the reference's vendored tinyobjloader + GLInstanceGraphicsShape
pipeline (reference: src/objloader.h:154-161, src/wavefront/tiny_obj_loader.cpp)
with a small host-side reader producing exactly what the tracer needs:
``(V,3) float32`` vertices and ``(F,3) int32`` triangle indices. Polygons with
more than 3 vertices are fan-triangulated (tinyobj's `triangulate=true`
default behaviour). If the native C++ parser (native/libmcray_native.so) is
available it is used for large meshes; this pure-Python path is the fallback
and the correctness oracle.
"""

from __future__ import annotations

import numpy as np

from ..utils.native import get_native


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse an OBJ file -> (vertices (V,3) f32, faces (F,3) i32)."""
    native = get_native()
    if native is not None:
        out = native.load_obj(path)
        if out is not None:
            return out
    return _load_obj_py(path)


def _load_obj_py(path: str) -> tuple[np.ndarray, np.ndarray]:
    verts: list[tuple[float, float, float]] = []
    faces: list[tuple[int, int, int]] = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                verts.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("f "):
                p = line.split()[1:]
                idx = []
                for tok in p:
                    i = int(tok.split("/")[0])
                    # OBJ is 1-based; negative indices are relative.
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))
    v = np.asarray(verts, dtype=np.float32).reshape(-1, 3)
    f_arr = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
    return v, f_arr


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in faces:
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")
