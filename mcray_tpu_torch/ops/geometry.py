"""Vector math and brute-force ray-triangle closest hit.

Port of ``mcray_tpu/ops/geometry.py:19-186``. Rays are ``(N, 3)`` float32
tensors and triangles are kept as a ``(9, T)`` SoA table of ``v0, e1, e2``.
Dot and cross products are written out component by component, in the
order the reference's ``jnp.sum``/``jnp.cross`` evaluate them, so the
closest hit (and the CUDA kernel that mirrors these formulas) picks the
same triangle as the reference.
"""

from __future__ import annotations

import torch

#: No-hit sentinel for the ray parameter t (t is in [0, 1] along the segment).
NO_HIT_T = 2.0


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def rotate(v: torch.Tensor, axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation of ``v`` about unit ``axis`` by ``angle`` (the
    btVector3::rotate decomposition the reference chains for probe pose,
    src/transducer.h:51-56). Broadcasts over leading dims of ``v``."""
    axis = axis.to(v.dtype)
    o = axis * dot3(axis, v)[..., None]
    x = v - o
    y = cross3(axis.expand_as(v), v)
    return o + x * torch.cos(angle) + y * torch.sin(angle)


def euler_zxy(v: torch.Tensor, angles_rad: torch.Tensor) -> torch.Tensor:
    """About z by angles[..., 2], then x by angles[..., 0], then y by
    angles[..., 1]; ``angles_rad`` (..., 3) broadcasts against ``v``'s
    leading dims (one rotation, or one per pose of a batch)."""
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    v = rotate(v, eye[2], angles_rad[..., 2:3])
    v = rotate(v, eye[0], angles_rad[..., 0:1])
    return rotate(v, eye[1], angles_rad[..., 1:2])


def safe_sqrt(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """sqrt with a finite gradient at 0: the double ``where`` keeps the inf
    of d sqrt/dx at 0 out of masked lanes (inf * 0 = NaN)."""
    ok = x > eps
    return torch.where(ok, torch.sqrt(torch.where(ok, x, 1.0)), 0.0)


def safe_norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """L2 norm over the last axis, with a finite (zero) gradient at 0."""
    n = safe_sqrt(dot3(v, v))
    return n[..., None] if keepdim else n


def distance_in_mm(a, b, spacing):
    """World distance with per-axis spacing, x10 to mm (src/scene.cpp:281-290)."""
    return safe_norm(torch.abs(a - b) * spacing) * 10.0


def normalize(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    n = torch.clamp(safe_norm(v, keepdim=True), min=eps if eps else 1e-30)
    return v / n


def triangle_soa(tris: torch.Tensor) -> torch.Tensor:
    """(T, 3, 3) vertices -> contiguous (9, T) rows [v0 xyz, e1 xyz, e2 xyz]."""
    v0 = tris[:, 0]
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    return torch.cat([v0, e1, e2], dim=1).T.contiguous()


def _moller_trumbore(origin, seg, v0, e1, e2, eps: float = 1e-9):
    """t and validity of segment ``origin + t*seg`` against triangles
    (broadcast), with Bullet's both-sided semantics (front and back faces
    hit; the reference never sets kF_FilterBackfaces)."""
    pvec = cross3(seg, e2)
    det = dot3(e1, pvec)
    det_ok = torch.abs(det) > eps
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, torch.ones_like(det)), 0.0)
    tvec = origin - v0
    u = dot3(tvec, pvec) * inv_det
    qvec = cross3(tvec, e1)
    v = dot3(seg, qvec) * inv_det
    t = dot3(e2, qvec) * inv_det
    valid = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0) & (t < 1.0)
    return t, valid


def closest_hit(origins, seg_vecs, tri_soa, *, chunk: int = 4096):
    """Brute closest hit over all triangles, chunked over rays so that the
    (rays x triangles) grid of one chunk bounds peak memory. Returns
    (best_t (N,) f32 — NO_HIT_T on a miss, best_idx (N,) int64). Ties go to
    the lowest triangle index, as ``jnp.argmin`` does."""
    v0, e1, e2 = tri_soa[0:3].T, tri_soa[3:6].T, tri_soa[6:9].T
    best_t, best_idx = [], []
    for s in range(0, origins.shape[0], chunk):
        t, valid = _moller_trumbore(
            origins[s : s + chunk, None, :], seg_vecs[s : s + chunk, None, :],
            v0[None], e1[None], e2[None],
        )
        t, j = torch.min(torch.where(valid, t, NO_HIT_T), dim=1)
        best_t.append(t)
        best_idx.append(j)
    return torch.cat(best_t), torch.cat(best_idx)


def hit_record(origins, seg_vecs, hit, v0, e1, e2, mesh_id, eps: float = 1e-9):
    """The per-ray hit record of the winning triangle (``v0, e1, e2`` per
    ray): ``hit``, ``t``, ``point``, the face ``normal`` oriented toward the
    segment origin (as Bullet's ClosestRayResultCallback reports it,
    reference src/scene.cpp:115-126) and ``mesh_id`` (-1 on a miss).

    ``t`` is recomputed here from the winner by the same Möller–Trumbore
    formula (bitwise the kernels' value: they are built without FMA
    contraction), so gradients flow through the hit point into ``origins``
    and ``seg_vecs`` while the closest-hit kernels, which only make the
    discrete choice, see detached rays."""
    t_diff, _ = _moller_trumbore(origins, seg_vecs, v0, e1, e2, eps=eps)
    best_t = torch.where(hit, t_diff, NO_HIT_T)
    face_n = normalize(cross3(e1, e2), eps=1e-20)
    flip = dot3(face_n, seg_vecs) > 0.0
    return {
        "hit": hit,
        "t": best_t,
        "point": origins + best_t[:, None] * seg_vecs,
        "normal": torch.where(flip[:, None], -face_n, face_n),
        "mesh_id": torch.where(hit, mesh_id.int(), -1),
    }


def winner_hits(origins, seg_vecs, tri_soa, tri_mesh_id, best_t, best_idx):
    """The hit record of the winning triangle (index into ``tri_soa``);
    ``best_t`` only decides hit or miss."""
    best_idx = best_idx.long()
    return hit_record(origins, seg_vecs, best_t < 1.5,
                      tri_soa[0:3].T.index_select(0, best_idx),
                      tri_soa[3:6].T.index_select(0, best_idx),
                      tri_soa[6:9].T.index_select(0, best_idx),
                      tri_mesh_id.index_select(0, best_idx))


def intersect_closest(origins, seg_vecs, tris, tri_mesh_id, *, chunk: int = 4096):
    """Closest hit of each segment against all triangles (brute force);
    the port of the reference's ``geometry.intersect_closest``."""
    tri_soa = triangle_soa(tris)
    best_t, best_idx = closest_hit(origins.detach(), seg_vecs.detach(), tri_soa, chunk=chunk)
    return winner_hits(origins, seg_vecs, tri_soa, tri_mesh_id, best_t, best_idx)
