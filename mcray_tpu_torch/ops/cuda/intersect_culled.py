"""K6: closest hit over cluster tiles with a per-tile AABB skip (``csrc/intersect_culled.cu``).

Replaces ``mcray_tpu/ops/pallas/intersect.py:_intersect_culled_kernel``
(wrapper ``intersect_closest_culled``): every packet of rays visits every
cluster tile of the permuted SoA in order and skips a tile when no ray of
the packet passes its AABB against its own running t. The winner tail
(``clusters.winner_hits``) recomputes t from the winning slot.

The plain version visits the tiles for all packets at once, one tile per
step, with the kernel's skip rule and strict ``<``; t and slot equal the
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


def culled_best_plain(rays, packed: clusters.CulledTris, tile_r: int):
    """Plain version: rays (6, n_tot) -> (best_t (n_tot,) f32, best_slot (n_tot,) i32)."""
    p = rays.shape[1] // tile_r
    o = rays[0:3].T.reshape(p, tile_r, 3)
    s = rays[3:6].T.reshape(p, tile_r, 3)
    inv = clusters.inverse_dirs(s)
    t = torch.full((p, tile_r), NO_HIT_T, device=rays.device)
    idx = torch.zeros((p, tile_r), dtype=torch.int32, device=rays.device)
    tt = packed.tile_t
    for base in range(0, packed.n_slots, tt):
        tiles = packed.soa[:, base : base + tt].expand(p, -1, -1)
        take = clusters.box_active(o, inv, tiles[:, 9:15, 0], t).any(dim=1)
        if bool(take.any()):
            t, idx = clusters.tile_update(o, s, t, idx, tiles,
                                          torch.full((p,), base, dtype=torch.int32,
                                                     device=rays.device), take)
    return t.reshape(-1), idx.reshape(-1)


def culled_best(rays, packed: clusters.CulledTris, tile_r: int):
    """(best_t, best_slot) of every ray: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    global launches
    if rays.device.type == "cpu" and packed.device.type == "cpu":
        return culled_best_plain(rays, packed, tile_r)
    n_tot = rays.shape[1]
    if n_tot % tile_r or not 32 <= tile_r <= 1024 or tile_r % 32:
        raise ValueError(f"tile_r {tile_r} must be a multiple of 32 in [32, 1024] dividing {n_tot}")
    _build.require(rays, "rays", torch.float32, (6, n_tot))
    _build.require(packed.soa, "soa", torch.float32, (clusters.SOA_ROWS, packed.n_slots))
    best_t = torch.empty(n_tot, dtype=torch.float32, device=rays.device)
    best_slot = torch.empty(n_tot, dtype=torch.int32, device=rays.device)
    code = _build.library().mcray_intersect_culled(
        rays.data_ptr(), n_tot, tile_r, packed.soa.data_ptr(), packed.n_slots, packed.tile_t,
        best_t.data_ptr(), best_slot.data_ptr(), _build.stream_of(rays),
    )
    _build.check(code, "mcray_intersect_culled")
    launches += 1
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
