"""Flat BVH: construction (host side), the 4-wide layout K11 walks, and the plain traversals.

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
the reference walk. The kernel's bound is reckoned from its node and test
counts and from the nodes and triangles it touches, and the card's walk
below equals its (t, index) bitwise.

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

The card walks another layout of the same tree (``DeviceBVH.from_flat``,
``collapse4``): the binary tree collapsed to a 4-wide one, each node one
128-byte record of its up to four children (each child the flat node's
padded box, then an inner node's index or a leaf's first triangle and
count), and the triangles as three float4s each in the BVH order (v0, e1,
e2, the scene index in the first's w). ``bvh4_best_plain`` walks it as the
kernel does: a live ray (non-zero segment) starts at the root; of a node's
children it keeps those whose box the segment enters before
``min(t_best, 1)`` (the same slab test, the same floats); it tests every
kept leaf's triangles; it then visits the nearest kept inner child whose
entry t is still below ``min(t_best, 1)``, pushing the others that still are
with their entry t, farthest first (ties by slot); with none, it pops
entries, dropping any whose stored entry t is no longer below
``min(t_best, 1)``. A box that holds a hit at ``t`` is entered before ``t``,
strictly (the padding), so every prune is conservative in any order, and
the least (t, index) is the same: the result is ``bvh_best_plain``'s and the
brute closest hit's, bit for bit.
Its stack holds ``STACK4`` entries; the layout records the most its walk can
need (``stack_need``), and the walk raises where that is more.
"""

from __future__ import annotations

import dataclasses
import functools
import sys

import numpy as np
import torch

from ..utils.native import get_native
from . import geometry

STACK_DEPTH = 64
#: stack entries a ray of the 4-wide walk holds (``csrc/bvh_intersect.cu:STACK``)
STACK4 = 64
#: children of a node of the 4-wide tree, and 32-bit words a child's record takes
WIDTH, CHILD_WORDS = 4, 8
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
class Collapsed4:
    """The 4-wide tree over a ``FlatBVH``, on the host, node 0 the root."""
    slots: np.ndarray     # (M, 4) i32: the flat node each child slot holds, -1 where empty
    children: np.ndarray  # (M, 4) i32: an inner slot's 4-wide node, else -1
    depth: int            # 4-wide nodes on the longest root-to-leaf path
    stack_need: int       # the most stack entries the 4-wide walk can hold at once


def collapse4(flat: FlatBVH) -> Collapsed4:
    """Collapse the binary tree to a 4-wide one. Each 4-wide node over a flat
    inner node takes its two children, then splits its inner child of the
    largest box surface (the earliest on a tie) into that child's two, until
    it holds four or only leaves; the children keep the flat depth-first
    order. A root that is a leaf becomes a node whose one child is that leaf.
    Nodes are numbered as they are reached: a node's inner children take
    consecutive numbers."""
    meta = np.asarray(flat.meta, np.int64)
    lo, hi = np.asarray(flat.nodes[:, :3], np.float64), np.asarray(flat.nodes[:, 3:], np.float64)
    d = hi - lo
    area = (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]).tolist()
    right, count = meta[:, 0].tolist(), meta[:, 1].tolist()

    def slots_of(node: int) -> list[int]:
        held = [node + 1, right[node]]
        while len(held) < WIDTH:
            inner = [c for c in held if count[c] < 0]
            if not inner:
                break
            split = max(inner, key=lambda c: (area[c], -c))
            at = held.index(split)
            held[at:at + 1] = [split + 1, right[split]]
        return sorted(held)

    # the root; a flat root that is a leaf (or holds no triangle) is its one child
    slots, children, level = [[0, -1, -1, -1]], [[-1] * WIDTH], [1]
    work = [(0, 0, 1)] if count[0] < 0 else []
    while work:
        flat_node, me, depth = work.pop()
        held = slots_of(flat_node)
        kids = []
        for c in held:
            if count[c] < 0:
                kids.append(len(slots))
                slots.append([])
                children.append([])
                level.append(depth + 1)
            else:
                kids.append(-1)
        slots[me] = held + [-1] * (WIDTH - len(held))
        children[me] = kids + [-1] * (WIDTH - len(kids))
        work.extend((c, k, depth + 1) for c, k in reversed(list(zip(held, kids))) if k >= 0)
    children_np = np.asarray(children, np.int32).reshape(-1, WIDTH)
    # the stack: a node pushes all its inner children but the one it visits;
    # the most is reached by descending into the child that needs the most
    need = [0] * len(children)
    for me in range(len(children) - 1, -1, -1):
        kids = [k for k in children[me] if k >= 0]
        if kids:
            need[me] = len(kids) - 1 + max(need[k] for k in kids)
    return Collapsed4(slots=np.asarray(slots, np.int32).reshape(-1, WIDTH), children=children_np,
                      depth=max(level), stack_need=need[0])


def _padded_boxes(flat: FlatBVH) -> np.ndarray:
    """(N, 6) f32: the flat tree's boxes, each padded by BOX_PAD x the scene's extent."""
    nodes = np.asarray(flat.nodes, np.float32)
    pad = np.float32(BOX_PAD * max(1.0, float(np.abs(nodes).max(initial=0.0))))
    return np.concatenate([nodes[:, :3] - pad, nodes[:, 3:] + pad], axis=1)


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceBVH:
    """A ``FlatBVH`` on the device of the scene's (9, T) triangles, in two
    layouts, each built at its first use: the 4-wide tree the card walks
    (``collapse4``; ``from_flat`` builds it at once), and the binary tree with
    its boxes padded and the triangles in its order, which only the
    reference walk ``bvh_best_plain`` (the oracle and the bound's yardstick)
    reads."""
    flat: FlatBVH
    scene_soa: torch.Tensor  # (9, T) f32 v0/e1/e2 rows, in the scene's order

    @classmethod
    def from_flat(cls, flat: FlatBVH, tri_soa: torch.Tensor) -> "DeviceBVH":
        """``flat`` on the device of ``tri_soa``, the scene's (9, T)
        triangles, its 4-wide layout built and uploaded now."""
        bvh = cls(flat, tri_soa)
        bvh.nodes4, bvh.tris4  # noqa: B018
        return bvh

    # the binary tree (``bvh_best_plain``)
    @functools.cached_property
    def nodes(self) -> torch.Tensor:
        """(N, 6) f32, each box padded by BOX_PAD x the scene's extent."""
        return torch.as_tensor(_padded_boxes(self.flat), device=self.scene_soa.device)

    @functools.cached_property
    def meta(self) -> torch.Tensor:
        """(N, 2) i32, as ``FlatBVH.meta``."""
        return torch.as_tensor(np.asarray(self.flat.meta, np.int32),
                               device=self.scene_soa.device).contiguous()

    @functools.cached_property
    def tri_order(self) -> torch.Tensor:
        """(T,) i32: BVH position -> triangle index."""
        return torch.as_tensor(np.asarray(self.flat.tri_order, np.int32),
                               device=self.scene_soa.device)

    @functools.cached_property
    def tri_soa(self) -> torch.Tensor:
        """(9, T) f32 v0/e1/e2 rows, in BVH order."""
        return self.scene_soa.index_select(1, self.tri_order.long()).contiguous()

    # the 4-wide tree (K11, ``bvh4_best_plain``)
    @functools.cached_property
    def tree4(self) -> Collapsed4:
        return collapse4(self.flat)

    @property
    def depth(self) -> int:
        """4-wide nodes on the longest root-to-leaf path."""
        return self.tree4.depth

    @property
    def stack_need(self) -> int:
        """The most stack entries the 4-wide walk can hold."""
        return self.tree4.stack_need

    @functools.cached_property
    def nodes4(self) -> torch.Tensor:
        """(M, 4, 8) i32, a 128-byte record a 4-wide node: per child [padded
        box min xyz, max xyz as f32 bits, ref, count]: an inner child (ref =
        its node, count -1), a leaf (ref = its first triangle in the BVH
        order, count >= 1) or an empty slot (count 0)."""
        tree, meta = self.tree4, np.asarray(self.flat.meta, np.int32)
        held = np.maximum(tree.slots, 0)
        records = np.zeros((tree.slots.shape[0], WIDTH, CHILD_WORDS), np.int32)
        records[..., 0:6] = _padded_boxes(self.flat)[held].view(np.int32)
        leaf = meta[held, 1] >= 0
        records[..., 6] = np.where(leaf, meta[held, 0], tree.children)
        records[..., 7] = np.where(leaf, meta[held, 1], -1)
        records[tree.slots < 0] = 0
        return torch.as_tensor(records, device=self.scene_soa.device).contiguous()

    @functools.cached_property
    def tris4(self) -> torch.Tensor:
        """(T, 12) f32 in BVH order: [v0 xyz, scene index as i32 bits, e1 xyz,
        0, e2 xyz, 0]."""
        order = torch.as_tensor(np.asarray(self.flat.tri_order, np.int32),
                                device=self.scene_soa.device)
        soa = self.scene_soa.index_select(1, order.long())
        tris4 = torch.zeros((soa.shape[1], 12), dtype=torch.float32, device=soa.device)
        for k, rows in enumerate((slice(0, 3), slice(3, 6), slice(6, 9))):
            tris4[:, 4 * k:4 * k + 3] = soa[rows].T
        tris4[:, 3] = order.view(torch.float32)
        return tris4


def _slab(origin, inv_seg, bmin, bmax):
    """(enter, leave): where the segment enters and leaves the box, in units of the segment."""
    t0 = (bmin - origin) * inv_seg
    t1 = (bmax - origin) * inv_seg
    return torch.amax(torch.minimum(t0, t1), dim=-1), torch.amin(torch.maximum(t0, t1), dim=-1)


def _slab_test(origin, inv_seg, bmin, bmax, t_best):
    """Segment against box: True where the box can hold a hit closer than
    ``min(t_best, 1)`` (``mcray_tpu/ops/bvh.py:110-119``)."""
    enter, leave = _slab(origin, inv_seg, bmin, bmax)
    return (enter <= leave) & (leave > 0.0) & (enter < torch.clamp(t_best, max=1.0))


def bvh_best_plain(rays: torch.Tensor, bvh: DeviceBVH, *, leaf_size: int = 4,
                   counts: bool = False, touched: bool = False):
    """Plain version of the traversal: rays (6, N) [origin xyz, segment xyz]
    -> (best_t (N,) f32, best_idx (N,) i32, the triangle's index in the
    scene); a miss is (NO_HIT_T, 0). With ``counts``, also (2, N) i32: the
    nodes each ray popped and the triangles it tested. With ``touched``, then
    also the (N_nodes,) and (T,) bool masks of the nodes any ray popped and
    the triangles (by BVH position) any ray tested."""
    n, t_total = rays.shape[1], bvh.tri_soa.shape[1]
    device = rays.device
    best_t = torch.full((n,), geometry.NO_HIT_T, dtype=torch.float32, device=device)
    best_i = torch.zeros(n, dtype=torch.int32, device=device)
    popped = torch.zeros(n, dtype=torch.int32, device=device)
    tested = torch.zeros(n, dtype=torch.int32, device=device)
    seen_nodes = torch.zeros(bvh.nodes.shape[0], dtype=torch.bool, device=device)
    seen_tris = torch.zeros(t_total, dtype=torch.bool, device=device)

    def result():
        out = (best_t, best_i) + ((torch.stack([popped, tested]),) if counts else ())
        return out + ((seen_nodes, seen_tris),) if touched else out

    if t_total == 0:
        return result()
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
            seen_tris[j[take]] = True
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
        seen_nodes[node[active]] = True
    return result()


def check_stack(bvh: DeviceBVH) -> None:
    """Raise unless the 4-wide walk's stack holds all that ``bvh`` can push."""
    if bvh.stack_need > STACK4:
        raise ValueError(f"the 4-wide BVH (depth {bvh.depth}) can need {bvh.stack_need} stack "
                         f"entries; the walk holds {STACK4}")


def bvh4_best_plain(rays: torch.Tensor, bvh: DeviceBVH, *, counts: bool = False):
    """Plain version of the card's walk of the 4-wide tree (the module's
    docstring; ``csrc/bvh_intersect.cu``), masked over all rays: rays (6, N)
    -> (best_t, best_idx) as ``bvh_best_plain`` gives them; with ``counts``
    also (2, N) i32: the 4-wide nodes each ray visited and the triangles it
    tested (a ray with a zero segment visits none)."""
    check_stack(bvh)
    n, t_total = rays.shape[1], bvh.tris4.shape[0]
    device = rays.device
    best_t = torch.full((n,), geometry.NO_HIT_T, dtype=torch.float32, device=device)
    best_i = torch.zeros(n, dtype=torch.int32, device=device)
    visited = torch.zeros(n, dtype=torch.int32, device=device)
    tested = torch.zeros(n, dtype=torch.int32, device=device)
    if t_total == 0:
        return (best_t, best_i, torch.stack([visited, tested])) if counts else (best_t, best_i)
    origin, seg = rays[0:3].T, rays[3:6].T
    inv_seg = torch.where(seg.abs() > 1e-30, 1.0 / seg, 1e30)
    boxes = bvh.nodes4[..., 0:6].contiguous().view(torch.float32)
    refs, sizes = bvh.nodes4[..., 6], bvh.nodes4[..., 7]
    v0, e1, e2 = bvh.tris4[:, 0:3], bvh.tris4[:, 4:7], bvh.tris4[:, 8:11]
    scene_idx = bvh.tris4[:, 3].contiguous().view(torch.int32)
    leaf_max = max(1, int(sizes.max()))
    slot = torch.arange(WIDTH, device=device)
    tie = slot[:, None] < slot[None, :]
    stack_node = torch.zeros((n, STACK4), dtype=torch.int32, device=device)
    stack_enter = torch.zeros((n, STACK4), dtype=torch.float32, device=device)
    sp = torch.zeros(n, dtype=torch.int64, device=device)
    node = torch.zeros(n, dtype=torch.int64, device=device)
    active = (seg != 0.0).any(dim=1)
    rows = torch.arange(n, device=device)
    k_range = torch.arange(leaf_max, device=device)
    no_idx = torch.iinfo(torch.int32).max
    while bool(active.any()):
        visited += active.int()
        ref, size = refs[node], sizes[node]
        enter, leave = _slab(origin[:, None], inv_seg[:, None], boxes[node, :, 0:3],
                             boxes[node, :, 3:6])
        hit = (active[:, None] & (size != 0) & (enter <= leave) & (leave > 0.0)
               & (enter < torch.clamp(best_t, max=1.0)[:, None]))
        # before[ray, j, c]: child j comes before child c in (entry t, slot) order
        before = (enter[:, :, None] < enter[:, None, :]) | (
            (enter[:, :, None] == enter[:, None, :]) & tie)
        # every kept leaf's triangles, and the least (t, index) among them
        leaf = hit & (size > 0)
        j = ref[:, :, None] + k_range
        take = leaf[:, :, None] & (k_range < size[:, :, None])
        j = torch.where(take, j, 0)
        t, valid = geometry._moller_trumbore(origin[:, None, None], seg[:, None, None], v0[j],
                                             e1[j], e2[j])
        valid = (valid & take).flatten(1)
        t = t.flatten(1)
        t_min = torch.where(valid, t, torch.inf).amin(dim=1)
        i_min = torch.where(valid & (t == t_min[:, None]), scene_idx[j].flatten(1),
                            no_idx).amin(dim=1)
        tested += torch.where(leaf, size, 0).sum(dim=1, dtype=torch.int32)
        win = (t_min < best_t) | ((t_min == best_t) & (i_min < best_i))
        best_t = torch.where(win, t_min, best_t)
        best_i = torch.where(win, i_min, best_i)
        # the kept inner children: the nearest is visited, the others pushed farthest first
        keep = hit & (size < 0) & (enter < torch.clamp(best_t, max=1.0)[:, None])
        kept = keep.sum(dim=1)
        rank = (keep[:, :, None] & before).sum(dim=1)
        go_down = kept > 0
        nearest = (keep & (rank == 0)).int().argmax(dim=1)
        for c in range(WIDTH):
            push = keep[:, c] & (rank[:, c] > 0)
            at = torch.where(push, sp + kept - 1 - rank[:, c], 0)[:, None]
            for stack, value in ((stack_node, ref[:, c]), (stack_enter, enter[:, c])):
                stack.scatter_(1, at, torch.where(push, value, stack.gather(1, at)[:, 0])[:, None])
        sp = sp + torch.where(go_down, kept - 1, 0)
        node = torch.where(go_down, ref[rows, nearest].long(), node)
        # the others pop, dropping what is no longer entered before min(best, 1)
        found = go_down
        pending = active & ~go_down
        while bool(pending.any()):
            can = pending & (sp > 0)
            sp = sp - can.long()
            at = sp.clamp(min=0)[:, None]
            ok = can & (stack_enter.gather(1, at)[:, 0] < torch.clamp(best_t, max=1.0))
            node = torch.where(ok, stack_node.gather(1, at)[:, 0].long(), node)
            found = found | ok
            pending = can & ~ok
        active = active & found
    return (best_t, best_i, torch.stack([visited, tested])) if counts else (best_t, best_i)


def bvh_intersect_closest(origins, seg_vecs, tris, tri_mesh_id, nodes, meta, tri_order, *,
                          leaf_size: int = 4) -> dict[str, torch.Tensor]:
    """Closest hit of each segment by the plain traversal, with the
    reference's arguments (``tris`` (T, 3, 3), the ``FlatBVH`` arrays) and
    the brute closest hit's result dict (``geometry.intersect_closest``)."""
    tri_soa = geometry.triangle_soa(torch.as_tensor(tris, dtype=torch.float32))
    bvh = DeviceBVH(FlatBVH(np.asarray(nodes), np.asarray(meta), np.asarray(tri_order)), tri_soa)
    rays = torch.cat([origins, seg_vecs], dim=1).detach().T
    best_t, best_idx = bvh_best_plain(rays, bvh, leaf_size=leaf_size)
    return geometry.winner_hits(origins, seg_vecs, tri_soa, torch.as_tensor(tri_mesh_id), best_t,
                                best_idx)
