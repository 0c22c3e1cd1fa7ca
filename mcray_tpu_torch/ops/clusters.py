"""Triangle clusters for the culled, staged, listed and grouped closest-hit kernels.

Port of the host packing and the plain-tensor parts around the reference's
cluster kernels (``mcray_tpu/ops/pallas/intersect.py``):

- ``CulledTris`` / ``pack_tris_culled`` (``:186-382``): triangles permuted
  into the BVH's depth-first order, cut into ``tile_t``-wide clusters,
  clusters sorted nearest-first to ``sort_origin``; each cluster carries its
  AABB. Padding slots are degenerate (det == 0, never hit); padding clusters
  carry a FAR degenerate box (min == max == 1e30) that every slab test
  rejects.
- ``winner_hits`` (``:385-409``): the hit record of the kernel-chosen slot,
  with ``t`` recomputed from the winning triangle.
- ``packet_sort_keys`` / ``intersect_sorted`` (``:412-457``): the opt-in
  coherence sort of rays into packets.
- ``packet_cluster_lists`` (``:643-856``): the listed kernel's prepass, per
  ray packet the clusters any ray's slab test reaches, front to back, with
  the ``exact``, ``frustum`` and ``hier`` methods.
- ``cluster_ray_tables`` / ``ray_winners`` (``:1278-1370``, ``:1414-1437``):
  the grouped kernel's cluster-major compaction (each cluster's first rays
  whose slab test reaches it) and the per-ray reduction of its per-(cluster,
  slot) results (the plain version's; K10 reduces in the kernel by the same
  integer key).
- ``box_active`` / ``tile_update``: the two steps every cluster kernel
  takes per cluster, in plain torch, shared by the kernels' plain versions.

The packing runs in numpy on the host, exactly as the reference's does, and
the tables become tensors on ``device``; the rest is torch on any device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .geometry import NO_HIT_T, _moller_trumbore, hit_record

SOA_ROWS = 16   # v0 xyz, e1 xyz, e2 xyz (9) + cluster AABB (6) + 1 pad row
TILE_T = 256    # triangles per cluster for the culled and staged kernels
SUPER_G = 8     # clusters per super-cluster (staged kernel, hier prepass)
FAR = 1e30
BIG = 1e30      # inverse direction of a zero direction component

_ARRAY_FIELDS = ("soa", "slot_all", "hbm_tris", "aabb_cluster", "aabb_super",
                 "scene_lo", "scene_hi")
_STATIC_FIELDS = ("n_slots", "n_clusters", "n_super", "tile_t", "super_g")


@dataclasses.dataclass
class CulledTris:
    """Packed triangle clusters (tensors on one device)."""

    soa: torch.Tensor           # (16, n_slots) f32: rows 0-8 v0/e1/e2, 9-14 cluster AABB
    slot_all: torch.Tensor      # (n_slots, 10) f32 [v0 e1 e2 mesh_id] for the winner tail
    hbm_tris: torch.Tensor      # (n_clusters, 16, tile_t) f32, cluster-major SoA
    aabb_cluster: torch.Tensor  # (n_clusters, 8) f32 [min xyz, max xyz, 0, 0]
    aabb_super: torch.Tensor    # (n_super, 8) f32 over super_g clusters each
    scene_lo: torch.Tensor      # (3,) scene AABB, for packet sort keys
    scene_hi: torch.Tensor
    n_slots: int                # real clusters x tile_t
    n_clusters: int             # padded to a multiple of super_g
    n_super: int
    tile_t: int
    super_g: int

    @property
    def device(self) -> torch.device:
        return self.hbm_tris.device

    @classmethod
    def from_arrays(cls, arrays: dict, statics: dict, device="cpu") -> "CulledTris":
        """From arrays (anything ``np.array`` takes) named as the fields."""
        return cls(
            **{f: torch.as_tensor(np.array(arrays[f], np.float32), device=device)
               for f in _ARRAY_FIELDS},
            **{k: int(statics[k]) for k in _STATIC_FIELDS},
        )


def pack_tris_culled(tris, tri_mesh_id, order=None, sort_origin=None, tile_t: int = TILE_T,
                     super_g: int | None = None, *, device="cpu") -> CulledTris:
    """Permute triangles into spatial ``order`` (the BVH's ``tri_order``),
    visit clusters nearest-first to ``sort_origin`` (the probe position), and
    pack ``tile_t``-wide clusters with their AABBs. ``super_g`` defaults to
    the reference's adaptive width, which keeps ``n_super`` near 256."""
    tris = np.asarray(tris, np.float32)
    tri_mesh_id = np.asarray(tri_mesh_id, np.int32)
    t = tris.shape[0]
    order = np.arange(t) if order is None else np.asarray(order)
    if sort_origin is not None and t > tile_t:
        so = np.asarray(sort_origin, np.float32)
        cent = tris[order].mean(axis=1)
        keys = np.empty((-(-t // tile_t),), np.float32)
        for c in range(keys.shape[0]):
            keys[c] = np.linalg.norm(cent[c * tile_t : (c + 1) * tile_t].mean(axis=0) - so)
        order = np.concatenate(
            [order[c * tile_t : (c + 1) * tile_t] for c in np.argsort(keys, kind="stable")])
    tris_o = tris[order]
    n_slots = t + (-t) % tile_t
    n_real = n_slots // tile_t

    v0 = tris_o[:, 0]
    e1 = tris_o[:, 1] - tris_o[:, 0]
    e2 = tris_o[:, 2] - tris_o[:, 0]
    aabb_c = np.zeros((n_real, 8), np.float32)
    for ci in range(n_real):
        chunk = tris_o[ci * tile_t : (ci + 1) * tile_t].reshape(-1, 3)
        aabb_c[ci, 0:3] = chunk.min(axis=0)
        aabb_c[ci, 3:6] = chunk.max(axis=0)
    soa = np.zeros((SOA_ROWS, n_slots), np.float32)
    soa[0:3, :t], soa[3:6, :t], soa[6:9, :t] = v0.T, e1.T, e2.T
    soa[9:15] = np.repeat(aabb_c[:, 0:6].T, tile_t, axis=1)

    slot_all = np.zeros((n_slots, 10), np.float32)
    slot_all[:t, 0:3], slot_all[:t, 3:6], slot_all[:t, 6:9] = v0, e1, e2
    slot_all[:, 9] = -1.0
    slot_all[:t, 9] = tri_mesh_id[order]  # mesh ids are small ints: exact in f32

    # cluster-major copy, padded to a super_g multiple with FAR clusters
    if super_g is None:
        super_g = max(SUPER_G, int(2 ** np.ceil(np.log2(max(n_real / 256.0, 1.0)))))
    n_clusters = -(-n_real // super_g) * super_g
    n_super = n_clusters // super_g
    hbm = np.zeros((n_clusters, SOA_ROWS, tile_t), np.float32)
    hbm[:n_real] = soa.reshape(SOA_ROWS, n_real, tile_t).transpose(1, 0, 2)
    hbm[n_real:, 9:15] = FAR
    aabb_cluster = np.zeros((n_clusters, 8), np.float32)
    aabb_cluster[:, 0:6] = FAR
    aabb_cluster[:n_real] = aabb_c
    # super boxes over the real clusters only (a FAR sentinel must not leak
    # into a mixed super's max)
    aabb_super = np.zeros((n_super, 8), np.float32)
    for si in range(n_super):
        real = aabb_c[si * super_g : (si + 1) * super_g]
        if real.shape[0] == 0:
            aabb_super[si, 0:6] = FAR
        else:
            aabb_super[si, 0:3] = real[:, 0:3].min(axis=0)
            aabb_super[si, 3:6] = real[:, 3:6].max(axis=0)

    flat = tris.reshape(-1, 3)
    arrays = {
        "soa": soa, "slot_all": slot_all, "hbm_tris": hbm,
        "aabb_cluster": aabb_cluster, "aabb_super": aabb_super,
        "scene_lo": flat.min(axis=0) if t else np.zeros(3, np.float32),
        "scene_hi": flat.max(axis=0) if t else np.ones(3, np.float32),
    }
    statics = {"n_slots": n_slots, "n_clusters": n_clusters, "n_super": n_super,
               "tile_t": tile_t, "super_g": super_g}
    return CulledTris.from_arrays(arrays, statics, device)


def winner_hits(origins, seg_vecs, packed: CulledTris, best_slot, hit, eps: float = 1e-9):
    """Hit record of the winning slot, from one (N, 10) gather of
    ``slot_all``; ``t`` is recomputed from the winning triangle (the paths
    built on clusters return it, not the kernel's)."""
    rows = packed.slot_all.index_select(0, best_slot.long())
    return hit_record(origins, seg_vecs, hit, rows[:, 0:3], rows[:, 3:6], rows[:, 6:9],
                      rows[:, 9], eps=eps)


def pad_rays(origins, seg_vecs, tile_r: int, origin_fill: float = 0.0):
    """Pad the rays to a multiple of ``tile_r`` with zero segments (a zero
    direction hits nothing) at ``origin_fill`` and return (origins,
    seg_vecs, rays (6, n_tot) contiguous)."""
    n_pad = (-origins.shape[0]) % tile_r
    if n_pad:
        origins = torch.cat([origins, origins.new_full((n_pad, 3), origin_fill)])
        seg_vecs = torch.cat([seg_vecs, seg_vecs.new_zeros((n_pad, 3))])
    return origins, seg_vecs, torch.cat([origins, seg_vecs], dim=1).T.contiguous()


# ---------------------------------------------------------------------------
# Packet coherence sort (opt-in)
# ---------------------------------------------------------------------------

def _part1by2_5bit(x):
    """Spread 5 bits to every 3rd position (bits 0, 3, 6, 9, 12)."""
    x = (x | (x << 8)) & 0x10F
    x = (x | (x << 4)) & 0x10C3
    return (x | (x << 2)) & 0x1249


def packet_sort_keys(origins, seg_vecs, packed: CulledTris):
    """Direction octant (3 bits) above a 15-bit origin Morton code."""
    lo = packed.scene_lo
    span = torch.clamp(packed.scene_hi - lo, min=1e-6)
    q = torch.clamp((origins - lo) / span * 32.0, 0.0, 31.0).int()
    m = (_part1by2_5bit(q[:, 0]) << 2) | (_part1by2_5bit(q[:, 1]) << 1) | _part1by2_5bit(q[:, 2])
    octant = (((seg_vecs[:, 0] > 0).int() << 2) | ((seg_vecs[:, 1] > 0).int() << 1)
              | (seg_vecs[:, 2] > 0).int())
    return (octant << 15) | m


def intersect_sorted(intersect_fn, origins, seg_vecs, packed: CulledTris):
    """Run ``intersect_fn`` on coherence-sorted rays and unsort its results."""
    perm = torch.argsort(packet_sort_keys(origins.detach(), seg_vecs.detach(), packed),
                         stable=True)
    hits = intersect_fn(origins[perm], seg_vecs[perm], packed)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return {k: v[inv] for k, v in hits.items()}


# ---------------------------------------------------------------------------
# Listed prepass: per-packet surviving-cluster lists
# ---------------------------------------------------------------------------

def inverse_dirs(s):
    """1/s per component, BIG where |s| <= 1e-30 (the kernels' slab inverse)."""
    ok = torch.abs(s) > 1e-30
    return torch.where(ok, 1.0 / torch.where(ok, s, torch.ones_like(s)), BIG)


def _slab(o, inv, box):
    """(enter, leave) of rays against boxes [min xyz, max xyz, ...]: ``o``,
    ``inv`` (..., 3) and ``box`` (..., >=6) broadcast against each other."""
    enter = leave = None
    for ax in range(3):
        t0 = (box[..., ax] - o[..., ax]) * inv[..., ax]
        t1 = (box[..., 3 + ax] - o[..., ax]) * inv[..., ax]
        mn, mx = torch.minimum(t0, t1), torch.maximum(t0, t1)
        enter = mn if enter is None else torch.maximum(enter, mn)
        leave = mx if leave is None else torch.minimum(leave, mx)
    return enter, leave


def _slab_all(o, inv, aabb):
    """(enter, leave), each (P, R, B), of rays (P, R, 3) against every box of (B, 8)."""
    return _slab(o[:, :, None], inv[:, :, None], aabb[None, None])


def _assemble_lists(any_hit, key):
    """(P, C) survival mask and lower-bound key -> (counts (P,) i32, ids
    (P, C) i32, keys (P, C) f32): survivors first, ascending in key, by one
    stable sort that carries the cluster ids (as the reference's
    ``lax.sort``, stable by default); non-survivor keys are NO_HIT_T."""
    key = torch.where(any_hit, key, torch.inf)
    keys_sorted, ids = torch.sort(key, dim=1, stable=True)
    counts = any_hit.sum(dim=1).int()
    return counts, ids.int(), torch.clamp(keys_sorted, max=NO_HIT_T)


def _frustum_cluster_hits(o, s, aabb):
    """Interval slab test of each packet (rays (P, R, 3)) against boxes:
    (P, B) survival mask and an entry-t lower bound sound for every live ray."""
    valid = torch.abs(s).sum(dim=-1) > 0.0  # parked dead rays drop out
    vmask = valid[:, :, None]
    inv = inverse_dirs(s)
    o_lo = torch.where(vmask, o, torch.inf).amin(dim=1)
    o_hi = torch.where(vmask, o, -torch.inf).amax(dim=1)
    i_lo = torch.where(vmask, inv, torch.inf).amin(dim=1)
    i_hi = torch.where(vmask, inv, -torch.inf).amax(dim=1)
    enter_lb = leave_ub = None
    for ax in range(3):
        near_a = far_a = None
        for bb in (aabb[None, :, ax], aabb[None, :, 3 + ax]):
            for oo in (o_lo[:, ax : ax + 1], o_hi[:, ax : ax + 1]):
                d = bb - oo
                for ii in (i_lo[:, ax : ax + 1], i_hi[:, ax : ax + 1]):
                    prod = d * ii
                    near_a = prod if near_a is None else torch.minimum(near_a, prod)
                    far_a = prod if far_a is None else torch.maximum(far_a, prod)
        enter_lb = near_a if enter_lb is None else torch.maximum(enter_lb, near_a)
        leave_ub = far_a if leave_ub is None else torch.minimum(leave_ub, far_a)
    any_hit = ((enter_lb <= leave_ub) & (leave_ub > 0.0) & (enter_lb < 1.0)
               & valid.any(dim=1)[:, None])
    return any_hit, torch.clamp(enter_lb, min=0.0)


def _lists_hier(o, s, packed: CulledTris):
    """Exact per-ray slab test at the super level intersected with the
    frustum test at the cluster level; key = the larger of the two bounds."""
    live = (torch.abs(s).sum(dim=-1) > 0.0)[:, :, None]
    enter, leave = _slab_all(o, inverse_dirs(s), packed.aabb_super)
    hit_s = (enter <= leave) & (leave > 0.0) & (enter < 1.0) & live
    key_s = torch.where(hit_s, torch.clamp(enter, min=0.0), torch.inf).amin(dim=1)
    g = packed.super_g
    any_s_c = hit_s.any(dim=1).repeat_interleave(g, dim=1)
    key_s_c = key_s.repeat_interleave(g, dim=1)
    any_f, key_f = _frustum_cluster_hits(o, s, packed.aabb_cluster)
    return _assemble_lists(any_f & any_s_c, torch.maximum(key_f, key_s_c))


def packet_cluster_lists(origins, seg_vecs, packed: CulledTris, tile_r: int, t_cap=None,
                         exclude=None, method: str = "exact"):
    """Per ``tile_r``-ray packet: ``counts`` (P,) of clusters some ray's slab
    test reaches before ``min(t_cap, 1)``, ``ids`` (P, C) with those clusters
    first in ascending ``keys`` (the packet's earliest slab entry), which
    lower-bound every ray's entry t, so the kernel may stop once the next key
    is >= the packet's worst running t. ``exclude`` (P, C) drops clusters an
    earlier pass visited. ``frustum`` and ``hier`` are cheaper supersets
    (single pass only)."""
    p = origins.shape[0] // tile_r
    o = origins.reshape(p, tile_r, 3)
    s = seg_vecs.reshape(p, tile_r, 3)
    if method in ("frustum", "hier"):
        if t_cap is not None or exclude is not None:
            raise ValueError(f"the {method} prepass is single-pass")
        if method == "frustum":
            return _assemble_lists(*_frustum_cluster_hits(o, s, packed.aabb_cluster))
        return _lists_hier(o, s, packed)
    if method != "exact":
        raise ValueError(f"unknown list method {method!r}")
    enter, leave = _slab_all(o, inverse_dirs(s), packed.aabb_cluster)
    cap = 1.0 if t_cap is None else torch.clamp(t_cap, max=1.0).reshape(p, tile_r, 1)
    hit = (enter <= leave) & (leave > 0.0) & (enter < cap)
    any_hit = hit.any(dim=1)
    if exclude is not None:
        any_hit = any_hit & ~exclude
    key = torch.where(hit, torch.clamp(enter, min=0.0), torch.inf).amin(dim=1)
    return _assemble_lists(any_hit, key)


# ---------------------------------------------------------------------------
# Grouped prepass: per-cluster ray tables, and the per-ray winner
# ---------------------------------------------------------------------------

GROUP_CHUNK = 128  # rays per chunk of the cluster-major compaction


def group_width(n_tot: int, group_g: int, chunk_g: int) -> int:
    """Ray slots per cluster: ``group_g`` shrunk to what ``n_tot`` rays can
    fill (``chunk_g`` per 128-ray chunk), a multiple of 8, at least 8."""
    g = min(group_g, max(8, (n_tot // GROUP_CHUNK) * chunk_g))
    return (g // 8) * 8 or 8


def ray_cluster_hits(origins, seg_vecs, packed: CulledTris):
    """(hit (N, C) bool, live (N,) bool): each live ray's slab test against
    every cluster box, inside the segment; inert rays (zero segment:
    padding and parked dead rays) reach no cluster."""
    live = torch.abs(seg_vecs).sum(dim=1) > 0.0
    enter, leave = _slab(origins[:, None], inverse_dirs(seg_vecs)[:, None],
                         packed.aabb_cluster[None])
    return (enter <= leave) & (leave > 0.0) & (enter < 1.0) & live[:, None], live


def cluster_ray_tables(hit, group_g: int, chunk_g: int):
    """Cluster-major compaction of the (N, C) ray-cluster incidences, N a
    multiple of 128: per cluster the ids of the rays it keeps, by the
    reference's rule — of every 128-ray chunk its first ``chunk_g`` rays, in
    ray order, and of those the first ``g = group_width(...)`` overall.
    Returns ``ray_ids`` (C, g) i32 (0 in the unused slots), ``counts`` (C,)
    i32 of used slots, and ``overflow`` (C,) bool: the cluster dropped a ray
    (a chunk or the cluster itself was over its budget), so a residual pass
    must test it in full.

    Static shapes and no host read. The reference extracts the ids by
    one-hot matmuls and packs them with a sort because a TPU has no scatter;
    here the in-chunk rank (a cumulative sum, which is monotone) gives the
    position of the chunk's k-th ray by one count, and the slot of each kept
    ray is its chunk's offset plus k, written by one small scatter."""
    n_tot, n_c = hit.shape
    if n_tot % GROUP_CHUNK:
        raise ValueError(f"{n_tot} rays: the grouped prepass takes multiples of {GROUP_CHUNK}")
    g = group_width(n_tot, group_g, chunk_g)
    n_ch = n_tot // GROUP_CHUNK
    device = hit.device
    rank = torch.cumsum(hit.reshape(n_ch, GROUP_CHUNK, n_c), dim=1, dtype=torch.int32)
    counts_ch = rank[:, -1, :]                                   # (n_ch, C)
    kept_ch = torch.clamp(counts_ch, max=chunk_g)
    first_slot = torch.cumsum(kept_ch, dim=0) - kept_ch          # of each chunk, per cluster
    total = kept_ch.sum(dim=0)
    # the chunk's k-th hitting ray sits after the rays whose rank is <= k
    k = torch.arange(chunk_g, device=device)
    in_chunk = torch.stack([(rank <= i).sum(dim=1) for i in range(chunk_g)], dim=1)
    ray = in_chunk + (torch.arange(n_ch, device=device) * GROUP_CHUNK)[:, None, None]
    slot = first_slot[:, None, :] + k[None, :, None]             # (n_ch, chunk_g, C)
    keep = (k[None, :, None] < kept_ch[:, None, :]) & (slot < g)
    dest = torch.where(keep, torch.arange(n_c, device=device) * g + slot, n_c * g)
    table = torch.zeros(n_c * g + 1, dtype=torch.int32, device=device)
    table.scatter_(0, dest.reshape(-1), ray.reshape(-1).int())   # slot n_c * g: the discards
    overflow = (counts_ch > chunk_g).any(dim=0) | (total > g)
    return table[:-1].reshape(n_c, g), torch.clamp(total, max=g).int(), overflow


NO_HIT_KEY = 0x40000000 << 32  # (bits of NO_HIT_T = 2.0f) << 32 | slot 0


def ray_winners(ray_ids, inc_t, inc_slot, n_tot: int):
    """Per ray the smallest t over its (cluster, slot) incidences and, on
    equal t, the smallest triangle slot; (NO_HIT_T, 0) for a ray with none.
    Returns (t (n_tot,) f32, slot (n_tot,) i32).

    The pair is packed into one integer key, (bits of t) << 32 | slot — a
    positive f32 orders as its bits — and reduced with an integer minimum,
    which does not depend on the order of the updates. Unused table slots
    hold ray 0 with (NO_HIT_T, 0), the reduction's own start value, so they
    change nothing and need no mask. (The reference sorts (ray, t, slot)
    triples twice for want of a scatter.)"""
    key = (inc_t.reshape(-1).view(torch.int32).long() << 32) | inc_slot.reshape(-1).long()
    best = torch.full((n_tot,), NO_HIT_KEY, dtype=torch.int64, device=key.device)
    best.scatter_reduce_(0, ray_ids.reshape(-1).long(), key, "amin", include_self=True)
    return (best >> 32).int().view(torch.float32), (best & 0xFFFFFFFF).int()


# ---------------------------------------------------------------------------
# The per-cluster steps of the kernels, in plain torch
# ---------------------------------------------------------------------------

def ray_groups(rays, size: int):
    """Rays (6, n) cut into groups of ``size`` consecutive rays, the last
    padded with zero rays, as the culled and staged kernels take them:
    origins and segments (G, size, 3), inverse directions, which rays can hit
    anything (a zero segment cannot: padding and parked dead paths), and the
    running best (t NO_HIT_T, slot 0), each (G, size)."""
    n_pad = (-rays.shape[1]) % size
    if n_pad:
        rays = torch.cat([rays, rays.new_zeros((6, n_pad))], dim=1)
    g = rays.shape[1] // size
    o = rays[0:3].T.reshape(g, size, 3)
    s = rays[3:6].T.reshape(g, size, 3)
    t = torch.full((g, size), NO_HIT_T, device=rays.device)
    idx = torch.zeros((g, size), dtype=torch.int32, device=rays.device)
    return o, s, inverse_dirs(s), (s != 0).any(dim=2), t, idx


def box_active(o, inv, box, t):
    """(P, R): each ray's slab test against its packet's box (P, >=6) [min
    xyz, max xyz], as the kernels test it: entry before ``min(t, 1)``."""
    enter, leave = _slab(o, inv, box[:, None])
    return (enter <= leave) & (leave > 0.0) & (enter < torch.clamp(t, max=1.0))


def tile_update(o, s, t, idx, tiles, base, take):
    """Closest hit of each packet's rays (P, R, 3) over its tile (P, >=9,
    tile_t) of v0/e1/e2 rows: where packet ``take`` holds and the tile's
    minimum t (first slot on ties) is strictly below the running ``t``,
    replace (t, idx) with (that t, ``base`` + slot). Returns (t, idx)."""
    v0, e1, e2 = (tiles[:, r : r + 3].transpose(1, 2)[:, None] for r in (0, 3, 6))
    tt, valid = _moller_trumbore(o[:, :, None], s[:, :, None], v0, e1, e2)
    tmin, targ = torch.where(valid, tt, NO_HIT_T).min(dim=2)
    better = take[:, None] & (tmin < t)
    return (torch.where(better, tmin, t),
            torch.where(better, base[:, None] + targ.int(), idx))
