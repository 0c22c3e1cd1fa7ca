"""Synthetic large scenes and ray sets for closest-hit stress queries.

The port's copy of the set-up of the reference's ``scripts/stress_bench.py``
(``build_scene_arrays``, ``make_rays``): a ball of random organ-like
ellipsoid shells totalling a given triangle count, a coherent probe fan and
an incoherent, bounce-like ray set. The incoherent set is what the grouped
closest hit (K10) was built for: isotropic directions from origins spread
through the scene, so a ray packet's cluster list approaches the whole
table while each ray's own list stays short.
"""

from __future__ import annotations

import numpy as np

from .primitives import ellipsoid_mesh


def build_scene_arrays(n_tris: int, seed: int = 0):
    """((n_tris, 3, 3) f32 triangles, (n_tris,) i32 mesh ids in 0-3): random
    ellipsoid shells (radii 0.5-3, centres within 5 units of the origin)."""
    rng = np.random.default_rng(seed)
    tris, mids = [], []
    sub = int(np.clip(np.sqrt(n_tris / 8), 8, 64))
    while sum(t.shape[0] for t in tris) < n_tris:
        v, f = ellipsoid_mesh(radii=rng.uniform(0.5, 3.0, 3), center=rng.uniform(-5, 5, 3),
                              n_theta=sub, n_phi=2 * sub)
        tris.append(v[f])
        mids.append(np.full((f.shape[0],), len(mids) % 4, np.int32))
    return (np.concatenate(tris)[:n_tris].astype(np.float32), np.concatenate(mids)[:n_tris])


def make_rays(n: int, seed: int = 1):
    """(fan origins, fan segments, bounce origins, bounce segments), each
    (n, 3) f32: a one-radian planar fan of 25-unit segments from
    (-12, 0, 0), and isotropic segments of length 2-12 from origins uniform
    in the 12-unit cube."""
    rng = np.random.default_rng(seed)
    origins = np.tile(np.array([[-12.0, 0.0, 0.0]], np.float32), (n, 1))
    theta = np.linspace(-0.5, 0.5, n)
    segs = np.stack([np.cos(theta) * 25, np.sin(theta) * 25, np.zeros(n)], -1).astype(np.float32)
    b_orig = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    b_dir = rng.normal(0, 1, (n, 3)).astype(np.float32)
    b_dir /= np.linalg.norm(b_dir, axis=1, keepdims=True)
    b_len = rng.uniform(2.0, 12.0, (n, 1)).astype(np.float32)
    return origins, segs, b_orig, (b_dir * b_len).astype(np.float32)
