"""K6: closest hit over cluster tiles with a per-tile AABB skip (``csrc/intersect_culled.cu``).

Replaces ``mcray_tpu/ops/pallas/intersect.py:_intersect_culled_kernel``
(wrapper ``intersect_closest_culled``): every packet of rays visits every
cluster tile of the permuted SoA in slot order and skips a tile when no ray
of the packet passes its AABB against its own running t. The winner tail
(``clusters.winner_hits``) recomputes t from the winning slot.

On the card the kernel is bound by latency, as K5 is, and has K5's shape: a
block takes ``GROUP`` rays with a warp each, not a packet, so the packet
size no longer shapes the launch and any ``tile_r`` that divides the padded
ray count runs. The group skips a tile when none of its rays reaches the
box; such a tile could at best tie for any of them, which a strict ``<``
never takes, so the winning t and slot do not depend on the group. Boxes
are tested 32 at a time into a candidate mask (from ``aabb_cluster``, the
same floats as the SoA's rows 9-14), and the next candidate's tile comes by
bulk asynchronous copy from the cluster-major ``hbm_tris`` while the
current one is tested (the source's header note has the details).

The plain version visits the tiles for all groups at once, one tile per
step, with the kernel's skip rule and strict ``<``; t and slot equal the
kernel's bitwise at the kernel's group, and at the whole packet.
"""

from __future__ import annotations

import torch

from .. import clusters
from . import _build


TILE_R = 128
#: rays per block of the kernel
GROUP = _build.CLUSTER_GROUP


def culled_best_plain(rays, packed: clusters.CulledTris, tile_r: int, group: int | None = None):
    """Plain version: rays (6, n_tot) -> (best_t (n_tot,) f32, best_slot (n_tot,) i32).

    ``group`` consecutive rays (``None``: the ``tile_r``-ray packet, as the
    reference) skip a tile together, as a block of the kernel does; rays
    with a zero segment take no part in the skip."""
    o, s, inv, live, t, idx = clusters.ray_groups(rays, tile_r if group is None else group)
    tt = packed.tile_t
    for base in range(0, packed.n_slots, tt):
        tiles = packed.soa[:, base : base + tt].expand(o.shape[0], -1, -1)
        take = (clusters.box_active(o, inv, tiles[:, 9:15, 0], t) & live).any(dim=1)
        if bool(take.any()):
            t, idx = clusters.tile_update(o, s, t, idx, tiles,
                                          torch.full((o.shape[0],), base, dtype=torch.int32,
                                                     device=rays.device), take)
    n_tot = rays.shape[1]
    return t.reshape(-1)[:n_tot], idx.reshape(-1)[:n_tot]


def culled_best(rays, packed: clusters.CulledTris, tile_r: int):
    """(best_t, best_slot) of every ray: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if rays.device.type == "cpu" and packed.device.type == "cpu":
        return culled_best_plain(rays, packed, tile_r)
    n_tot = rays.shape[1]
    if tile_r < 1 or n_tot % tile_r:
        raise ValueError(f"tile_r {tile_r} must be a positive divisor of the padded ray count "
                         f"{n_tot}")
    n_c, tt = packed.n_clusters, packed.tile_t
    _build.require(rays, "rays", torch.float32, (6, n_tot))
    _build.require(packed.hbm_tris, "hbm_tris", torch.float32, (n_c, clusters.SOA_ROWS, tt))
    _build.require(packed.aabb_cluster, "aabb_cluster", torch.float32, (n_c, 8))
    _build.require_tiles(packed, "mcray_intersect_culled")
    best_t = torch.empty(n_tot, dtype=torch.float32, device=rays.device)
    best_slot = torch.empty(n_tot, dtype=torch.int32, device=rays.device)
    _build.launch(
        "mcray_intersect_culled",
        rays.data_ptr(), n_tot, packed.hbm_tris.data_ptr(), packed.aabb_cluster.data_ptr(),
        packed.n_slots // tt, tt, best_t.data_ptr(), best_slot.data_ptr(), device=rays.device,
    )
    return best_t, best_slot


def intersect_closest_culled(origins, seg_vecs, packed: clusters.CulledTris, *,
                             tile_r: int = TILE_R, eps: float = 1e-9):
    """Closest hit of each segment over the cluster-culled tiles."""
    n = origins.shape[0]
    # the kernel makes the discrete choice only: it sees detached rays
    _, _, rays = clusters.pad_rays(origins.detach(), seg_vecs.detach(), tile_r)
    best_t, best_slot = culled_best(rays, packed, tile_r)
    hit = best_t[:n] < 1.5
    best_slot = torch.clamp(best_slot[:n], max=packed.n_slots - 1)
    return clusters.winner_hits(origins, seg_vecs, packed, best_slot, hit, eps)
