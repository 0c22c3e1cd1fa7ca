"""K7: two-level staged closest hit (``csrc/intersect_staged.cu``).

Replaces ``mcray_tpu/ops/pallas/intersect.py:_intersect_staged_kernel``
(wrapper ``intersect_closest_staged``): every packet of rays slab-tests the
super-cluster boxes, then the cluster boxes of each super some ray
reaches, and runs Möller–Trumbore only over the clusters some ray reaches,
each test against the rays' running t. The winner tail
(``clusters.winner_hits``) recomputes t from the winning slot.

The plain version walks the supers and clusters for all packets at once,
with the kernel's skip rules and strict ``<``; t and slot equal the
kernel's bitwise.
"""

from __future__ import annotations

import torch

from .. import clusters
from ..geometry import NO_HIT_T
from . import _build

#: kernel launches since the last reset (one per call on CUDA tensors)
launches = 0

TILE_R = 128


def staged_best_plain(rays, packed: clusters.CulledTris, tile_r: int):
    """Plain version: rays (6, n_tot) -> (best_t (n_tot,) f32, best_slot (n_tot,) i32)."""
    p = rays.shape[1] // tile_r
    o = rays[0:3].T.reshape(p, tile_r, 3)
    s = rays[3:6].T.reshape(p, tile_r, 3)
    inv = clusters.inverse_dirs(s)
    t = torch.full((p, tile_r), NO_HIT_T, device=rays.device)
    idx = torch.zeros((p, tile_r), dtype=torch.int32, device=rays.device)
    g = packed.super_g
    for sc in range(packed.n_super):
        in_super = clusters.box_active(o, inv, packed.aabb_super[sc].expand(p, -1), t).any(dim=1)
        if not bool(in_super.any()):
            continue
        for c in range(sc * g, (sc + 1) * g):
            take = in_super & clusters.box_active(
                o, inv, packed.aabb_cluster[c].expand(p, -1), t).any(dim=1)
            if bool(take.any()):
                t, idx = clusters.tile_update(
                    o, s, t, idx, packed.hbm_tris[c].expand(p, -1, -1),
                    torch.full((p,), c * packed.tile_t, dtype=torch.int32, device=rays.device),
                    take)
    return t.reshape(-1), idx.reshape(-1)


def staged_best(rays, packed: clusters.CulledTris, tile_r: int):
    """(best_t, best_slot) of every ray: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    global launches
    if rays.device.type == "cpu" and packed.device.type == "cpu":
        return staged_best_plain(rays, packed, tile_r)
    n_tot = rays.shape[1]
    if n_tot % tile_r or not 32 <= tile_r <= 1024 or tile_r % 32:
        raise ValueError(f"tile_r {tile_r} must be a multiple of 32 in [32, 1024] dividing {n_tot}")
    n_c, tt = packed.n_clusters, packed.tile_t
    _build.require(rays, "rays", torch.float32, (6, n_tot))
    _build.require(packed.aabb_super, "aabb_super", torch.float32, (packed.n_super, 8))
    _build.require(packed.aabb_cluster, "aabb_cluster", torch.float32, (n_c, 8))
    _build.require(packed.hbm_tris, "hbm_tris", torch.float32, (n_c, clusters.SOA_ROWS, tt))
    best_t = torch.empty(n_tot, dtype=torch.float32, device=rays.device)
    best_slot = torch.empty(n_tot, dtype=torch.int32, device=rays.device)
    code = _build.library().mcray_intersect_staged(
        rays.data_ptr(), n_tot, tile_r, packed.aabb_super.data_ptr(), packed.n_super,
        packed.super_g, packed.aabb_cluster.data_ptr(), packed.hbm_tris.data_ptr(), tt,
        best_t.data_ptr(), best_slot.data_ptr(), _build.stream_of(rays),
    )
    _build.check(code, "mcray_intersect_staged")
    launches += 1
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
