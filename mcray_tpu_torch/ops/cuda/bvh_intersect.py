"""K11: closest hit by traversal of the 4-wide BVH (``csrc/bvh_intersect.cu``).

No TPU kernel: the reference's traversal (``mcray_tpu/ops/bvh.py:121-212``,
what ``Simulator(use_bvh=True)`` and ``render --bvh`` select) is a jnp
``while_loop``, which its TPU backend does not compile
(``mcray_tpu/models/simulator.py:470-481``). On the card it walks
``DeviceBVH``'s 4-wide layout (``ops/bvh.py``), four lanes a ray (lane c
tests child c, the kept leaves' triangles one a lane), a warp's eight rays
in step, its stack in shared memory; its plain version is
``ops/bvh.py:bvh4_best_plain`` (the same walk masked over all rays), which
it equals bitwise in ``t``, winner and counts. With its padded boxes and its
(t, index) order it also equals the binary walk (``bvh_best_plain``) and the
brute closest hit (K1) bitwise, winner included (``ops/bvh.py`` says why the
reference's own traversal can part from its brute force).

As for K1, the winner tail (point, oriented normal, mesh id) is plain torch
(``geometry.winner_hits``), which recomputes the winner's ``t`` so that
gradients flow through the hit point while the kernel sees detached rays.
"""

from __future__ import annotations

import torch

from .. import bvh as bvh_mod
from .. import geometry
from . import _build


def bvh_best(rays: torch.Tensor, bvh: bvh_mod.DeviceBVH, *, counts: bool = False):
    """(best_t, best_idx) of every ray, as ``intersect.intersect_best`` gives
    them (and with ``counts`` the (2, N) 4-wide nodes visited and triangles
    tested): the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. Raises ``ValueError`` where the layout's walk can need more
    stack than the kernel holds."""
    bvh_mod.check_stack(bvh)
    if rays.device.type == "cpu" and bvh.tris4.device.type == "cpu":
        return bvh_mod.bvh4_best_plain(rays, bvh, counts=counts)
    n, t = rays.shape[1], bvh.tris4.shape[0]
    if n < 1:
        raise ValueError("rays: the kernel needs at least one ray")
    _build.require(rays, "rays", torch.float32, (6, n))
    _build.require(bvh.nodes4, "nodes4", torch.int32,
                   (bvh.nodes4.shape[0], bvh_mod.WIDTH, bvh_mod.CHILD_WORDS))
    _build.require(bvh.tris4, "tris4", torch.float32, (t, 12))
    if bvh.nodes4.data_ptr() % 16 or bvh.tris4.data_ptr() % 16:
        raise ValueError("nodes4 and tris4 must be 16-byte aligned (the kernel reads int4/float4)")
    best_t = torch.empty(n, dtype=torch.float32, device=rays.device)
    best_idx = torch.empty(n, dtype=torch.int32, device=rays.device)
    tally = torch.empty((2, n), dtype=torch.int32, device=rays.device) if counts else None
    _build.launch(
        "mcray_bvh_intersect",
        rays.data_ptr(), n, bvh.nodes4.data_ptr(), bvh.tris4.data_ptr(), t, bvh.stack_need,
        best_t.data_ptr(), best_idx.data_ptr(), tally.data_ptr() if counts else None,
        device=rays.device,
    )
    return (best_t, best_idx, tally) if counts else (best_t, best_idx)


def bvh_intersect_closest_cuda(origins, seg_vecs, tri_soa, tri_mesh_id, bvh: bvh_mod.DeviceBVH):
    """Closest hit of each segment: the kernel's winner, then the plain tail."""
    rays = torch.cat([origins, seg_vecs], dim=1).detach().T.contiguous()
    best_t, best_idx = bvh_best(rays, bvh)
    return geometry.winner_hits(origins, seg_vecs, tri_soa, tri_mesh_id, best_t, best_idx)
