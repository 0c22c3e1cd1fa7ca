"""Flat BVH construction (host side).

Port of ``mcray_tpu/ops/bvh.py:35-102``: the native binned-SAH construction of
``native/libmcray_native.so`` when it is built, else the same numpy
median-split fallback. Both packages load the same library (each through its
own ``utils/native.py``), so on one machine they produce the same
``tri_order``, which the cluster packing (``ops/clusters.py``) orders its
triangles by.

Layout (pointerless, depth-first):

- ``nodes``  (N, 6) f32: [min xyz, max xyz];
- ``meta``   (N, 2) i32: inner node -> (right child index, -1), the left
  child is ``i + 1``; leaf -> (first, count) into ``tri_order``;
- ``tri_order`` (T,) i32: each leaf's triangles contiguous.

The device traversal (the reference's ``--bvh`` path) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from ..utils.native import get_native


@dataclasses.dataclass
class FlatBVH:
    nodes: np.ndarray      # (N, 6) f32
    meta: np.ndarray       # (N, 2) i32
    tri_order: np.ndarray  # (T,) i32


def build_bvh(tris: np.ndarray, tri_mesh_id: np.ndarray | None = None,
              leaf_size: int = 4) -> FlatBVH:
    del tri_mesh_id  # ids are looked up through tri_order
    native = get_native()
    if native is not None:
        out = native.build_bvh(np.asarray(tris, np.float32), leaf_size)
        if out is not None:
            nodes, meta, order = out
            return FlatBVH(nodes=nodes, meta=meta, tri_order=order)
    return _build_bvh_py(np.asarray(tris, np.float32), leaf_size)


def _build_bvh_py(tris: np.ndarray, leaf_size: int) -> FlatBVH:
    """Median split on the longest centroid axis (stable argsort)."""
    t = tris.shape[0]
    if t == 0:
        return FlatBVH(
            nodes=np.zeros((1, 6), np.float32),
            meta=np.array([[0, 0]], np.int32),
            tri_order=np.zeros((0,), np.int32),
        )
    lo = tris.min(axis=1)
    hi = tris.max(axis=1)
    centroid = (lo + hi) * 0.5
    nodes: list[list[float]] = []
    meta: list[list[int]] = []
    order: list[int] = []

    def emit(idx: np.ndarray) -> int:
        my = len(nodes)
        nodes.append([*lo[idx].min(axis=0), *hi[idx].max(axis=0)])
        meta.append([0, 0])
        if idx.size <= leaf_size:
            meta[my] = [len(order), idx.size]
            order.extend(int(i) for i in idx)
            return my
        c = centroid[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        part = np.argsort(c[:, axis], kind="stable")
        half = idx.size // 2
        emit(idx[part[:half]])  # left child == my + 1
        meta[my] = [emit(idx[part[half:]]), -1]
        return my

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        emit(np.arange(t))
    finally:
        sys.setrecursionlimit(old)
    return FlatBVH(
        nodes=np.asarray(nodes, np.float32),
        meta=np.asarray(meta, np.int32),
        tri_order=np.asarray(order, np.int32),
    )
