"""K1: brute closest-hit ray-triangle intersection (``csrc/intersect.cu``).

Replaces ``mcray_tpu/ops/pallas/intersect.py:_intersect_kernel`` (wrapper
``intersect_closest_pallas``): Möller–Trumbore of every ray against every
triangle, keeping the running minimum ``t`` and its triangle index.

On the card: one thread per ray; each block stages 256-triangle tiles of
the (9, T) v0/e1/e2 SoA through shared memory, where every thread reads the
same word (a broadcast), and loops over them with a strict ``<`` update so
ties go to the lowest index, as ``jnp.argmin`` does. The work is
~30 f32 operations per ray-triangle pair with nothing re-read from device
memory, so the kernel is bound by f32 issue rate: 2,560 rays x 2,220
triangles per bounce on the sphere, 20 blocks of 128 rays — too few to
fill the card's 132 SMs, which is the first thing to change. FMA
contraction is off (``_build.py``), so the hit and index equal the plain
version's.

The winner tail (point, oriented normal, mesh id) is computed from the
winner in plain torch (``geometry.winner_hits``), as the reference wrapper
does; it recomputes the winner's t, so gradients flow through the hit point
while the kernel sees detached rays (it makes the discrete choice only).
Dead rays are parked at 1e9 with a zero segment: det == 0, so they miss.
"""

from __future__ import annotations

import torch

from .. import geometry
from . import _build

#: kernel launches since the last reset (one per call on a CUDA tensor)
launches = 0


def intersect_best_plain(rays: torch.Tensor, tri_soa: torch.Tensor):
    """Plain version: rays (6, N) [origin xyz, segment xyz], tri_soa (9, T)
    -> (best_t (N,) f32, best_idx (N,) i32)."""
    best_t, best_idx = geometry.closest_hit(rays[0:3].T, rays[3:6].T, tri_soa)
    return best_t, best_idx.int()


def intersect_best(rays: torch.Tensor, tri_soa: torch.Tensor):
    """(best_t, best_idx) of every ray: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    global launches
    if rays.device.type == "cpu" and tri_soa.device.type == "cpu":
        return intersect_best_plain(rays, tri_soa)
    n, t = rays.shape[1], tri_soa.shape[1]
    _build.require(rays, "rays", torch.float32, (6, n))
    _build.require(tri_soa, "tri_soa", torch.float32, (9, t))
    best_t = torch.empty(n, dtype=torch.float32, device=rays.device)
    best_idx = torch.empty(n, dtype=torch.int32, device=rays.device)
    code = _build.library().mcray_intersect_closest(
        rays.data_ptr(), n, tri_soa.data_ptr(), t,
        best_t.data_ptr(), best_idx.data_ptr(), _build.stream_of(rays),
    )
    _build.check(code, "mcray_intersect_closest")
    launches += 1
    return best_t, best_idx


def intersect_closest_cuda(origins, seg_vecs, tri_soa, tri_mesh_id):
    """Closest hit of each segment: the kernel's winner, then the plain tail."""
    rays = torch.cat([origins, seg_vecs], dim=1).detach().T.contiguous()
    best_t, best_idx = intersect_best(rays, tri_soa)
    return geometry.winner_hits(origins, seg_vecs, tri_soa, tri_mesh_id, best_t, best_idx)
