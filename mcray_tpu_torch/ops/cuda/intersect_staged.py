"""K7: two-level staged closest hit (``csrc/intersect_staged.cu``).

Replaces ``mcray_tpu/ops/pallas/intersect.py:_intersect_staged_kernel``
(wrapper ``intersect_closest_staged``): every packet of rays slab-tests the
super-cluster boxes, then the cluster boxes of each super some ray
reaches, and runs Möller–Trumbore only over the clusters some ray reaches,
each test against the rays' running t. The winner tail
(``clusters.winner_hits``) recomputes t from the winning slot.

On the card the kernel has K6's shape (``intersect_culled``): a block
takes ``GROUP`` rays with a warp each, so any ``tile_r`` that divides the
padded ray count runs, and the winning t and slot do not depend on the
group. Supers are tested 32 at a time into a mask, a reached super's
clusters in one more ballot, and tiles come by bulk asynchronous copy while
the previous one is tested (the source's header note has the details).

The plain version walks the supers and clusters for all groups at once,
with the kernel's skip rules and strict ``<``; t and slot equal the
kernel's bitwise at the kernel's group, and at the whole packet.
"""

from __future__ import annotations

import torch

from .. import clusters
from . import _build


TILE_R = 128
#: rays per block of the kernel
GROUP = _build.CLUSTER_GROUP


def staged_best_plain(rays, packed: clusters.CulledTris, tile_r: int, group: int | None = None):
    """Plain version: rays (6, n_tot) -> (best_t (n_tot,) f32, best_slot (n_tot,) i32).

    ``group`` consecutive rays (``None``: the ``tile_r``-ray packet, as the
    reference) skip a super and a cluster together, as a block of the
    kernel does; rays with a zero segment take no part in the skips."""
    o, s, inv, live, t, idx = clusters.ray_groups(rays, tile_r if group is None else group)
    p, g = o.shape[0], packed.super_g
    for sc in range(packed.n_super):
        in_super = (clusters.box_active(o, inv, packed.aabb_super[sc].expand(p, -1), t)
                    & live).any(dim=1)
        if not bool(in_super.any()):
            continue
        for c in range(sc * g, (sc + 1) * g):
            take = in_super & (clusters.box_active(
                o, inv, packed.aabb_cluster[c].expand(p, -1), t) & live).any(dim=1)
            if bool(take.any()):
                t, idx = clusters.tile_update(
                    o, s, t, idx, packed.hbm_tris[c].expand(p, -1, -1),
                    torch.full((p,), c * packed.tile_t, dtype=torch.int32, device=rays.device),
                    take)
    n_tot = rays.shape[1]
    return t.reshape(-1)[:n_tot], idx.reshape(-1)[:n_tot]


def staged_best(rays, packed: clusters.CulledTris, tile_r: int):
    """(best_t, best_slot) of every ray: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if rays.device.type == "cpu" and packed.device.type == "cpu":
        return staged_best_plain(rays, packed, tile_r)
    n_tot = rays.shape[1]
    if tile_r < 1 or n_tot % tile_r:
        raise ValueError(f"tile_r {tile_r} must be a positive divisor of the padded ray count "
                         f"{n_tot}")
    n_c, tt = packed.n_clusters, packed.tile_t
    _build.require(rays, "rays", torch.float32, (6, n_tot))
    _build.require(packed.aabb_super, "aabb_super", torch.float32, (packed.n_super, 8))
    _build.require(packed.aabb_cluster, "aabb_cluster", torch.float32, (n_c, 8))
    _build.require(packed.hbm_tris, "hbm_tris", torch.float32, (n_c, clusters.SOA_ROWS, tt))
    _build.require_tiles(packed, "mcray_intersect_staged")
    if packed.aabb_super.data_ptr() % 16:
        raise ValueError("aabb_super must be 16-byte aligned (the kernel reads a box as two float4)")
    best_t = torch.empty(n_tot, dtype=torch.float32, device=rays.device)
    best_slot = torch.empty(n_tot, dtype=torch.int32, device=rays.device)
    _build.launch(
        "mcray_intersect_staged",
        rays.data_ptr(), n_tot, packed.aabb_super.data_ptr(), packed.n_super, packed.super_g,
        packed.aabb_cluster.data_ptr(), packed.hbm_tris.data_ptr(), tt, best_t.data_ptr(),
        best_slot.data_ptr(), device=rays.device,
    )
    return best_t, best_slot


def intersect_closest_staged(origins, seg_vecs, packed: clusters.CulledTris, *,
                             tile_r: int = TILE_R, eps: float = 1e-9):
    """Closest hit of each segment through the two-level staged walk; the
    packing must use the default ``tile_t`` (256), as the reference asserts."""
    if packed.tile_t != clusters.TILE_T:
        raise ValueError(f"the staged kernel needs tile_t {clusters.TILE_T}, got {packed.tile_t}")
    n = origins.shape[0]
    # the kernel makes the discrete choice only: it sees detached rays
    _, _, rays = clusters.pad_rays(origins.detach(), seg_vecs.detach(), tile_r)
    best_t, best_slot = staged_best(rays, packed, tile_r)
    hit = best_t[:n] < 1.5
    best_slot = torch.clamp(best_slot[:n], max=packed.n_slots - 1)
    return clusters.winner_hits(origins, seg_vecs, packed, best_slot, hit, eps)
