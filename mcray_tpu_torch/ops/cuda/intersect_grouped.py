"""K10: cluster-major ("grouped") closest hit (``csrc/intersect_grouped.cu``).

Replaces ``mcray_tpu/ops/pallas/intersect.py:_intersect_grouped_kernel``
and its wrapper ``intersect_closest_grouped``, the reference's closest hit
for incoherent (bounce-style) rays on large scenes. The per-packet kernels
charge every cluster a packet visits to all of the packet's rays; isotropic
rays make a packet's list approach the whole cluster table. Here each
cluster is visited once, by exactly the rays whose slab test reaches it:

1. ``clusters.ray_cluster_hits`` / ``cluster_ray_tables`` (plain torch on
   every device): the dense (rays x clusters) slab mask and its compaction
   into each cluster's table of at most G ray ids;
2. the kernel (``grouped_winners``): per ray the least (t, slot) over the
   (cluster, slot) entries that hold it, each the closest hit among the
   cluster's triangles. The kernel reduces per ray itself, by a 64-bit
   integer minimum of (bits(t) << 32) | slot, so it equals
   ``clusters.ray_winners`` over the per-(cluster, slot) tables of
   ``grouped_best_plain`` bit for bit (``grouped_winners_plain``) and never
   writes those tables;
3. a residual listed pass (K5, ``listed_best``) over the clusters that
   dropped a ray (a coherent fan overflows the budgets), seeded with the
   grouped winners, so the result is exact whatever overflowed. It runs
   every time: reading whether anything overflowed would stall the host.

The reference batches ``batch_b`` clusters per program to amortise a TPU
grid-step cost; the card's kernel has warps claim the clusters that hold a
ray, and the argument is dropped.

On CPU tensors the per-(cluster, slot) tables (``grouped_best``, the plain
version run densely over clusters, slots and triangles in cluster chunks)
and their per-ray reduction stay: the CPU path and the tests that hold the
tables to the reference use them.
"""

from __future__ import annotations

import torch

from .. import clusters
from ..geometry import NO_HIT_T, _moller_trumbore
from . import _build
from .intersect_listed import TILE_R, listed_best


GROUP_G = 32  # ray slots per cluster (the reference's default budget)
CHUNK_G = 4   # of which at most this many from one 128-ray chunk
PLAIN_CLUSTER_CHUNK = 1024  # clusters per step of the plain version


def grouped_best_plain(rays, ray_ids, counts, packed: clusters.CulledTris):
    """Plain version: rays (6, n_tot), ray_ids (C, G) i32, counts (C,) i32 ->
    (t (C, G) f32, slot (C, G) i32): per used slot the minimum t over the
    cluster's triangles (NO_HIT_T if none) and cluster * tile_t + the first
    triangle attaining it; (NO_HIT_T, 0) in the unused slots."""
    n_c, g = ray_ids.shape
    o_all, s_all = rays[0:3].T, rays[3:6].T
    ts, slots = [], []
    for c0 in range(0, n_c, PLAIN_CLUSTER_CHUNK):
        ids = ray_ids[c0 : c0 + PLAIN_CLUSTER_CHUNK].long()
        tiles = packed.hbm_tris[c0 : c0 + PLAIN_CLUSTER_CHUNK]
        o = o_all.index_select(0, ids.reshape(-1)).reshape(*ids.shape, 1, 3)
        s = s_all.index_select(0, ids.reshape(-1)).reshape(*ids.shape, 1, 3)
        v0, e1, e2 = (tiles[:, r : r + 3].transpose(1, 2)[:, None] for r in (0, 3, 6))
        tt, valid = _moller_trumbore(o, s, v0, e1, e2)
        tmin, targ = torch.where(valid, tt, NO_HIT_T).min(dim=2)
        base = torch.arange(c0, c0 + ids.shape[0], device=ids.device) * packed.tile_t
        used = torch.arange(g, device=ids.device)[None, :] < counts[c0 : c0 + ids.shape[0], None]
        ts.append(torch.where(used, tmin, NO_HIT_T))
        slots.append(torch.where(used, base[:, None] + targ, 0).int())
    return torch.cat(ts), torch.cat(slots)


def grouped_best(rays, ray_ids, counts, packed: clusters.CulledTris):
    """(t, slot) of every (cluster, ray slot), on CPU tensors: the plain
    version. The card computes no such table (K10 reduces per ray in the
    kernel: ``grouped_winners``), so CUDA tensors raise."""
    if rays.device.type == "cpu" and packed.device.type == "cpu":
        return grouped_best_plain(rays, ray_ids, counts, packed)
    raise ValueError("grouped_best: the card reduces per ray in the kernel; use grouped_winners")


def grouped_winners_plain(rays, ray_ids, counts, packed: clusters.CulledTris):
    """Plain version of K10: (t (n_tot,) f32, slot (n_tot,) i32), per ray the
    least (t, slot) over its table entries, (NO_HIT_T, 0) for a ray with
    none: ``clusters.ray_winners`` over ``grouped_best_plain``."""
    return clusters.ray_winners(ray_ids, *grouped_best_plain(rays, ray_ids, counts, packed),
                                rays.shape[1])


def grouped_winners(rays, ray_ids, counts, packed: clusters.CulledTris):
    """Per ray (t, slot) of its table entries' closest hits: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors. The kernel takes G a
    multiple of 8 up to 256 and ``tile_t`` a multiple of 4 up to 3,200 (its
    shared memory); the C entry refuses anything else, and this raises
    ``ValueError`` with no launch."""
    if rays.device.type == "cpu" and packed.device.type == "cpu":
        return grouped_winners_plain(rays, ray_ids, counts, packed)
    n_tot, (n_c, g) = rays.shape[1], ray_ids.shape
    tiles, tile_t = packed.hbm_tris, packed.tile_t
    if tiles.data_ptr() % 16:
        raise ValueError("hbm_tris: expected 16-byte alignment (rows 0-8 of a tile come by "
                         "bulk copy)")
    _build.require(rays, "rays", torch.float32, (6, n_tot))
    _build.require(ray_ids, "ray_ids", torch.int32, (n_c, g))
    _build.require(counts, "counts", torch.int32, (n_c,))
    _build.require(tiles, "hbm_tris", torch.float32, (n_c, clusters.SOA_ROWS, tile_t))
    keys = torch.full((n_tot,), clusters.NO_HIT_KEY, dtype=torch.int64, device=rays.device)
    _build.launch(
        "mcray_intersect_grouped",
        rays.data_ptr(), n_tot, ray_ids.data_ptr(), counts.data_ptr(), n_c, g, tiles.data_ptr(),
        tile_t, keys.data_ptr(), device=rays.device,
    )
    # a key's halves (little-endian): the slot, then the bits of t; one copy
    # makes both rows contiguous
    halves = keys.view(torch.int32).view(n_tot, 2).T.contiguous()
    return halves[1].view(torch.float32), halves[0]


def intersect_closest_grouped(origins, seg_vecs, packed: clusters.CulledTris, *,
                              group_g: int = GROUP_G, chunk_g: int = CHUNK_G,
                              residual_tile_r: int = TILE_R, eps: float = 1e-9):
    """Closest hit of each segment, cluster-major, with the residual listed
    pass on ``residual_tile_r``-ray packets (a multiple of 128). Each cluster
    keeps the first ``chunk_g`` rays of every 128-ray chunk and at most
    ``group_g`` in all; what it drops goes to the residual pass."""
    if residual_tile_r % clusters.GROUP_CHUNK:
        raise ValueError(f"residual_tile_r {residual_tile_r} must be a multiple of "
                         f"{clusters.GROUP_CHUNK}")
    n = origins.shape[0]
    # the prepass and the kernels make the discrete choice only: they see
    # detached rays, and gradients flow through the winner tail alone.
    # Padding rays are parked like dead ones (far origin, zero segment).
    o, s, rays = clusters.pad_rays(origins.detach(), seg_vecs.detach(), residual_tile_r, 1e9)
    hit_m, live = clusters.ray_cluster_hits(o, s, packed)
    ray_ids, counts, overflow = clusters.cluster_ray_tables(hit_m, group_g, chunk_g)
    grouped_t, grouped_slot = grouped_winners(rays, ray_ids, counts, packed)

    # residual listed pass over the clusters that dropped a ray; each ray's
    # pruning bound is its grouped t, and inert lanes start at t = 0 so they
    # cannot hold the listed kernel's early stop open
    counts2, ids2, keys2 = clusters.packet_cluster_lists(
        o, s, packed, residual_tile_r, t_cap=grouped_t, exclude=~overflow[None, :])
    t0 = torch.where(live, grouped_t, 0.0)
    best_t, best_slot = listed_best(rays, counts2, ids2, keys2, t0, grouped_slot, packed)

    hit = live[:n] & (best_t[:n] < 1.5)
    best_slot = torch.clamp(best_slot[:n], max=packed.n_slots - 1)
    return clusters.winner_hits(origins, seg_vecs, packed, best_slot, hit, eps)
