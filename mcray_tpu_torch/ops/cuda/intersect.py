"""K1: brute closest-hit ray-triangle intersection (``csrc/intersect.cu``).

Replaces ``mcray_tpu/ops/pallas/intersect.py:_intersect_kernel`` (wrapper
``intersect_closest_pallas``): Möller–Trumbore of every ray against every
triangle, keeping the running minimum ``t`` and its triangle index.

On the card the work is ~50 f32 operations per ray-triangle test with
nothing re-read from device memory, so the kernel is bound by f32 issue
rate, and the launch has to fill the card's 132 SMs: the (t, index) minimum
is exact in any order, so the triangle axis is split across threads and
blocks. A block takes 32 rays (a lane each) and one of up to 8 slices of the
triangles; its 8 warps each walk a contiguous part of the slice in
ascending order with a strict ``<`` (ties to the lowest index, as
``jnp.argmin``), staging 32 triangles at a time in a two-stage ring in
shared memory and reading each as a broadcast. The warps' winners merge on
(t, index) in shared memory, and a thread-block cluster of the slices'
blocks merges theirs through distributed shared memory; one block writes
each ray's result. One launch per call: 2,560 rays x 8 slices make 640
blocks (``last_grid("intersect")``), where a thread per ray made 20. A cluster whose
32 rays all have a zero segment skips the walk (they cannot hit: det is
exactly 0). ``tests/test_torch_intersect.py`` holds that decomposition, in
plain torch, to ``intersect_best_plain`` bitwise for any number of parts.
FMA contraction is off (``_build.py``), so the hit and index equal the
plain version's.

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


def intersect_best_plain(rays: torch.Tensor, tri_soa: torch.Tensor):
    """Plain version: rays (6, N) [origin xyz, segment xyz], tri_soa (9, T)
    -> (best_t (N,) f32, best_idx (N,) i32); a miss (and every ray when T
    is 0) is (NO_HIT_T, 0)."""
    if tri_soa.shape[1] == 0:
        n = rays.shape[1]
        return (torch.full((n,), geometry.NO_HIT_T, dtype=torch.float32, device=rays.device),
                torch.zeros(n, dtype=torch.int32, device=rays.device))
    best_t, best_idx = geometry.closest_hit(rays[0:3].T, rays[3:6].T, tri_soa)
    return best_t, best_idx.int()


def intersect_best(rays: torch.Tensor, tri_soa: torch.Tensor):
    """(best_t, best_idx) of every ray: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. Any N >= 1 and T >= 0."""
    if rays.device.type == "cpu" and tri_soa.device.type == "cpu":
        return intersect_best_plain(rays, tri_soa)
    n, t = rays.shape[1], tri_soa.shape[1]
    if n < 1:
        raise ValueError("rays: the kernel needs at least one ray")
    _build.require(rays, "rays", torch.float32, (6, n))
    _build.require(tri_soa, "tri_soa", torch.float32, (9, t))
    best_t = torch.empty(n, dtype=torch.float32, device=rays.device)
    best_idx = torch.empty(n, dtype=torch.int32, device=rays.device)
    _build.launch(
        "mcray_intersect_closest",
        rays.data_ptr(), n, tri_soa.data_ptr(), t, best_t.data_ptr(), best_idx.data_ptr(),
        device=rays.device,
    )
    return best_t, best_idx


def intersect_closest_cuda(origins, seg_vecs, tri_soa, tri_mesh_id):
    """Closest hit of each segment: the kernel's winner, then the plain tail."""
    rays = torch.cat([origins, seg_vecs], dim=1).detach().T.contiguous()
    best_t, best_idx = intersect_best(rays, tri_soa)
    return geometry.winner_hits(origins, seg_vecs, tri_soa, tri_mesh_id, best_t, best_idx)
