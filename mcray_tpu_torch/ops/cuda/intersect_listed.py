"""K5: list-driven closest hit (``csrc/intersect_listed.cu``).

Replaces ``mcray_tpu/ops/pallas/intersect.py:_intersect_listed_kernel``
(``_listed_call`` and the wrapper ``intersect_closest_listed``), the
reference's default closest hit at 2,048 triangles and up. The prepass
(``clusters.packet_cluster_lists``, plain torch on every device) lists each
``tile_r``-ray packet's clusters front to back; the kernel walks the list
with a box re-check per cluster and stops once no ray can improve. The
winner tail (``clusters.winner_hits``) recomputes t from the winning slot.

On the card the kernel is bound by latency (a ray's walk is a chain of
dependent steps, and a bounce has only 2,560 rays), so a block takes
``GROUP`` rays of a packet, not the packet: each group walks the packet's
list with its own stop and its own box test, a warp shares each
ray's 128 triangle tests, the boxes of 32 list entries are tested at once
into a candidate mask, and the next candidate's tile arrives by bulk
asynchronous copy while the current one is tested (the source's header
note has the details). A list key is the minimum entry t over the whole
packet, so it bounds every subset's entry too: the group's stop drops only
clusters that could at best tie, which a strict ``<`` never takes, and the
winning t and slot do not depend on the group size.

The plain version walks the lists for all groups at once, one list slot
per step (tensors of (groups, rays, tile_t), never (groups, rays,
clusters x tile_t)), with the kernel's stop rule and strict ``<``; the
winning t and slot equal the kernel's bitwise.
"""

from __future__ import annotations

import torch

from ...utils import profiling
from .. import clusters
from ..geometry import NO_HIT_T
from . import _build


TILE_R = 128
#: rays per block of the kernel (each ray has a warp): 640 blocks of 128 threads
#: for a bounce of 2,560 rays
GROUP = _build.CLUSTER_GROUP


def listed_best_plain(rays, counts, ids, keys, t_init, idx_init, packed: clusters.CulledTris,
                      group: int | None = None):
    """Plain version: rays (6, n_tot), lists (P,), (P, C), (P, C), running
    best (n_tot,) -> (best_t (n_tot,) f32, best_slot (n_tot,) i32).

    ``group`` rays (a divisor of the packet size; ``None``: the whole
    packet) walk their packet's list together, with their own stop and
    their own box test, as a block of the kernel does."""
    p = counts.shape[0]
    tile_r = rays.shape[1] // p if p else 1
    if group is not None and p:
        if tile_r % group:
            raise ValueError(f"group {group} does not divide the packet size {tile_r}")
        k = tile_r // group
        counts, ids, keys = (x.repeat_interleave(k, dim=0) for x in (counts, ids, keys))
        p, tile_r = p * k, group
    o = rays[0:3].T.reshape(p, tile_r, 3)
    s = rays[3:6].T.reshape(p, tile_r, 3)
    inv = clusters.inverse_dirs(s)
    t = t_init.reshape(p, tile_r).clone()
    idx = idx_init.reshape(p, tile_r).clone()
    n_c = ids.shape[1]
    go = counts > 0
    for it in range(n_c):
        if not bool(go.any()):
            break
        # the next slot is visited if the group's worst running t, before
        # this cluster, still exceeds its key (one cluster stale, as the kernel)
        nxt = min(it + 1, n_c - 1)
        want_next = go & (it + 1 < counts) & (keys[:, nxt] < t.amax(dim=1))
        c = ids[:, it]
        tiles = packed.hbm_tris.index_select(0, c.long())
        active = clusters.box_active(o, inv, tiles[:, 9:15, 0], t)
        t, idx = clusters.tile_update(o, s, t, idx, tiles, c * packed.tile_t,
                                      go & active.any(dim=1))
        go = want_next
    return t.reshape(-1), idx.reshape(-1)


def listed_best(rays, counts, ids, keys, t_init, idx_init, packed: clusters.CulledTris):
    """(best_t, best_slot) of every ray: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if rays.device.type == "cpu" and packed.device.type == "cpu":
        return listed_best_plain(rays, counts, ids, keys, t_init, idx_init, packed)
    n_tot, (p, n_c) = rays.shape[1], ids.shape
    tile_r = n_tot // p
    if p * tile_r != n_tot or tile_r % GROUP:
        raise ValueError(f"rays per packet {n_tot}/{p} must be a whole multiple of {GROUP}: "
                         f"a block of the kernel takes {GROUP} rays of one packet")
    _build.require(rays, "rays", torch.float32, (6, n_tot))
    _build.require(counts, "counts", torch.int32, (p,))
    _build.require(ids, "ids", torch.int32, (p, n_c))
    _build.require(keys, "keys", torch.float32, (p, n_c))
    _build.require(t_init, "t_init", torch.float32, (n_tot,))
    _build.require(idx_init, "idx_init", torch.int32, (n_tot,))
    tiles, boxes = packed.hbm_tris, packed.aabb_cluster
    _build.require(tiles, "hbm_tris", torch.float32, (n_c, clusters.SOA_ROWS, packed.tile_t))
    _build.require(boxes, "aabb_cluster", torch.float32, (n_c, 8))
    _build.require_tiles(packed, "mcray_intersect_listed")
    best_t = torch.empty(n_tot, dtype=torch.float32, device=rays.device)
    best_slot = torch.empty(n_tot, dtype=torch.int32, device=rays.device)
    _build.launch(
        "mcray_intersect_listed",
        rays.data_ptr(), n_tot, tile_r, counts.data_ptr(), ids.data_ptr(), keys.data_ptr(), n_c,
        t_init.data_ptr(), idx_init.data_ptr(), tiles.data_ptr(), boxes.data_ptr(),
        packed.tile_t, best_t.data_ptr(), best_slot.data_ptr(), device=rays.device,
    )
    return best_t, best_slot


def intersect_closest_listed(origins, seg_vecs, packed: clusters.CulledTris, *,
                             tile_r: int = TILE_R, passes: int = 1, front_k: int = 6,
                             list_method: str = "exact", eps: float = 1e-9):
    """Closest hit of each segment through the cluster lists.

    ``passes=2`` first visits each packet's ``front_k`` nearest clusters,
    then lists again with each ray's pruning bound cut from the segment end
    to its pass-1 best t, excluding the clusters already visited."""
    n = origins.shape[0]
    # the prepass and the kernel make the discrete choice only: they see
    # detached rays, and gradients flow through the winner tail alone
    o, s, rays = clusters.pad_rays(origins.detach(), seg_vecs.detach(), tile_r)
    counts, ids, keys = clusters.packet_cluster_lists(o, s, packed, tile_r, method=list_method)
    profiling.mark("closest_hit", rays.device)
    # inert lanes (zero segment: padding and parked dead rays) start at
    # t = 0 so they cannot hold the kernel's early stop open; `hit`
    # re-masks them below
    live = torch.abs(s).sum(dim=1) > 0.0
    t0 = torch.where(live, NO_HIT_T, 0.0)
    i0 = torch.zeros_like(t0, dtype=torch.int32)
    if passes <= 1:
        best_t, best_slot = listed_best(rays, counts, ids, keys, t0, i0, packed)
    else:
        c1 = torch.clamp(counts, max=front_k)
        bt1, bs1 = listed_best(rays, c1, ids, keys, t0, i0, packed)
        # clusters pass 1 visited: each packet's first c1 list slots
        slots = torch.arange(ids.shape[1], device=ids.device)[None, :] < c1[:, None]
        visited = torch.zeros_like(slots).scatter_(1, ids.long(), slots)
        counts2, ids2, keys2 = clusters.packet_cluster_lists(
            o, s, packed, tile_r, t_cap=bt1, exclude=visited)
        best_t, best_slot = listed_best(rays, counts2, ids2, keys2, bt1, bs1, packed)
    hit = live[:n] & (best_t[:n] < 1.5)
    best_slot = torch.clamp(best_slot[:n], max=packed.n_slots - 1)
    return clusters.winner_hits(origins, seg_vecs, packed, best_slot, hit, eps)
