"""Flat BVH: construction (host side) and the plain stack traversal.

Port of ``mcray_tpu/ops/bvh.py``. Construction (``:35-102``): the native binned-SAH construction of
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

Traversal (``:110-212``, the reference's ``--bvh`` path): each ray pops
nodes from a ``STACK_DEPTH``-entry stack, starting at the root; a node whose
box the segment enters before its best ``t`` (the slab test) is a leaf whose
up to ``leaf_size`` triangles are tested (Möller–Trumbore), or an inner node
whose right child, then left child, are pushed (the left pops first). Stack
indices are clamped to the stack, as JAX clamps them. ``bvh_best_plain``
runs that loop masked over all rays at once, until every stack is empty:
the plain version of the CUDA kernel (``ops/cuda/bvh_intersect.py``, a
thread per ray), which it equals bitwise.

Two choices make the result the brute closest hit's, bit for bit (t and
triangle index), where the reference's traversal may part from its own
brute force:

- Boxes are padded by ``BOX_PAD`` of the scene's largest coordinate
  (``DeviceBVH.from_flat``). Unpadded, the slab test drops the box of a
  triangle that a segment running along the box's face hits on its edge:
  the rounded hit passes Möller–Trumbore's tests while the slab interval,
  divided by a near-zero direction component, closes before it, and the
  walk takes the neighbouring triangle's hit, a hair farther. The full-size
  sphere frame has such rays (bounce-1 rays in the fan's plane meeting the
  sphere's equator; ``tests/test_torch_bvh.py``).
- The winner is the least (t, triangle index), as the brute kernel's: on
  equal ``t`` the lower index wins, whatever the walk's order.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..utils.native import get_native
from . import geometry

STACK_DEPTH = 64
#: box padding, relative to the largest coordinate of the scene (a margin of
#: ~100x over f32 rounding of coordinates near that size)
BOX_PAD = 1e-5


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


@dataclasses.dataclass(frozen=True)
class DeviceBVH:
    """A ``FlatBVH`` on a device, its boxes padded, with the triangles in its order."""
    nodes: torch.Tensor      # (N, 6) f32, each box padded by BOX_PAD x the scene's extent
    meta: torch.Tensor       # (N, 2) i32
    tri_order: torch.Tensor  # (T,) i32: BVH position -> triangle index
    tri_soa: torch.Tensor    # (9, T) f32 v0/e1/e2 rows, in BVH order

    @classmethod
    def from_flat(cls, flat: FlatBVH, tri_soa: torch.Tensor) -> "DeviceBVH":
        """``flat`` on the device of ``tri_soa``, the scene's (9, T) triangles."""
        device = tri_soa.device
        nodes = np.asarray(flat.nodes, np.float32)
        pad = np.float32(BOX_PAD * max(1.0, float(np.abs(nodes).max(initial=0.0))))
        nodes = np.concatenate([nodes[:, :3] - pad, nodes[:, 3:] + pad], axis=1)
        order = torch.as_tensor(np.asarray(flat.tri_order, np.int32), device=device)
        return cls(
            nodes=torch.as_tensor(nodes, device=device).contiguous(),
            meta=torch.as_tensor(np.asarray(flat.meta, np.int32), device=device).contiguous(),
            tri_order=order,
            tri_soa=tri_soa.index_select(1, order.long()).contiguous(),
        )


def _slab_test(origin, inv_seg, bmin, bmax, t_best):
    """Segment against box: True where the box can hold a hit closer than
    ``min(t_best, 1)`` (``mcray_tpu/ops/bvh.py:110-119``)."""
    t0 = (bmin - origin) * inv_seg
    t1 = (bmax - origin) * inv_seg
    enter = torch.amax(torch.minimum(t0, t1), dim=-1)
    leave = torch.amin(torch.maximum(t0, t1), dim=-1)
    return (enter <= leave) & (leave > 0.0) & (enter < torch.clamp(t_best, max=1.0))


def bvh_best_plain(rays: torch.Tensor, bvh: DeviceBVH, *, leaf_size: int = 4,
                   counts: bool = False):
    """Plain version of the traversal: rays (6, N) [origin xyz, segment xyz]
    -> (best_t (N,) f32, best_idx (N,) i32, the triangle's index in the
    scene); a miss is (NO_HIT_T, 0). With ``counts``, also (2, N) i32: the
    nodes each ray popped and the triangles it tested."""
    n, t_total = rays.shape[1], bvh.tri_soa.shape[1]
    device = rays.device
    best_t = torch.full((n,), geometry.NO_HIT_T, dtype=torch.float32, device=device)
    best_i = torch.zeros(n, dtype=torch.int32, device=device)
    popped = torch.zeros(n, dtype=torch.int32, device=device)
    tested = torch.zeros(n, dtype=torch.int32, device=device)
    if t_total == 0:
        return (best_t, best_i, torch.stack([popped, tested])) if counts else (best_t, best_i)
    origin, seg = rays[0:3].T, rays[3:6].T
    inv_seg = torch.where(seg.abs() > 1e-30, 1.0 / seg, 1e30)
    v0, e1, e2 = bvh.tri_soa[0:3].T, bvh.tri_soa[3:6].T, bvh.tri_soa[6:9].T
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int32, device=device)
    sp = torch.ones(n, dtype=torch.int32, device=device)
    top = STACK_DEPTH - 1
    while True:
        active = sp > 0
        if not bool(active.any()):
            break
        sp = sp - active.int()
        node = stack.gather(1, sp.clamp(0, top).long()[:, None])[:, 0].long()
        box = bvh.nodes[node]
        m = bvh.meta[node]
        hit_box = active & _slab_test(origin, inv_seg, box[:, 0:3], box[:, 3:6], best_t)
        visit = hit_box & (m[:, 1] >= 0)
        for k in range(leaf_size):
            j = torch.clamp(m[:, 0] + k, max=t_total - 1).long()
            t, valid = geometry._moller_trumbore(origin, seg, v0[j], e1[j], e2[j])
            take = visit & (k < m[:, 1])
            tested += take.int()
            idx = bvh.tri_order[j]
            take = take & valid & ((t < best_t) | ((t == best_t) & (idx < best_i)))
            best_t = torch.where(take, t, best_t)
            best_i = torch.where(take, idx, best_i)
        push = hit_box & (m[:, 1] < 0)
        for slot, value in ((sp, m[:, 0]), (sp + 1, node.int() + 1)):
            idx = slot.clamp(0, top).long()[:, None]
            stack.scatter_(1, idx, torch.where(push, value, stack.gather(1, idx)[:, 0])[:, None])
        sp = sp + 2 * push.int()
        popped += active.int()
    return (best_t, best_i, torch.stack([popped, tested])) if counts else (best_t, best_i)


def bvh_intersect_closest(origins, seg_vecs, tris, tri_mesh_id, nodes, meta, tri_order, *,
                          leaf_size: int = 4) -> dict[str, torch.Tensor]:
    """Closest hit of each segment by the plain traversal, with the
    reference's arguments (``tris`` (T, 3, 3), the ``FlatBVH`` arrays) and
    the brute closest hit's result dict (``geometry.intersect_closest``)."""
    tri_soa = geometry.triangle_soa(torch.as_tensor(tris, dtype=torch.float32))
    bvh = DeviceBVH.from_flat(FlatBVH(np.asarray(nodes), np.asarray(meta), np.asarray(tri_order)),
                              tri_soa)
    rays = torch.cat([origins, seg_vecs], dim=1).detach().T
    best_t, best_idx = bvh_best_plain(rays, bvh, leaf_size=leaf_size)
    return geometry.winner_hits(origins, seg_vecs, tri_soa, torch.as_tensor(tri_mesh_id), best_t,
                                best_idx)
