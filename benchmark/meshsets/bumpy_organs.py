"""Mesh kind ``bumpy_organs``: the generated abdomen that stands in for the
11 organ meshes of 3D-IRCADb-01 patient 11 (the dataset is not shipped).

Each organ is a UV sphere of ``n_theta x 2 n_theta`` (``n_theta`` from the
organ's triangle target) pushed out by five random cosine lobes over the
unit sphere, scaled by its radii and moved to its centre, in the meshes'
own frame (the scene scales and places them). A configuration's ``meshes``
entry: ``{"kind": "bumpy_organs", "tris_scale": s, "seed_base": b,
"organs": [[stem, [rx, ry, rz], [cx, cy, cz], target], ...]}``: organ i
aims at ``s x target`` triangles from the seed ``b + i`` and is written as
``<stem>.obj``. The arithmetic is frozen here, operation for operation, so
that the set cannot move with the program.
"""

from __future__ import annotations

import numpy as np

from benchmark.meshsets.sphere_box import sphere_mesh


def organ_mesh(radii, center, n_tris_target, seed: int):
    """(vertices (V, 3) f32, faces (F, 3) i32) of one organ."""
    rng = np.random.default_rng(seed)
    n_theta = max(8, int(np.ceil(np.sqrt(n_tris_target / 4.0))))
    v, f = sphere_mesh(1.0, n_theta, 2 * n_theta)
    v = v + np.zeros(3, np.float32)  # the centre's add: each -0.0 becomes +0.0
    d = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
    bump = np.zeros(v.shape[0], np.float32)
    for k in range(1, 6):
        freq = rng.normal(0.0, k, 3).astype(np.float32)
        phase = rng.uniform(0, 2 * np.pi)
        bump += (0.5 / k) * np.cos(d @ freq * 2.0 + phase).astype(np.float32)
    v = v * (1.0 + 0.12 * bump)[:, None]
    v = v * np.asarray(radii, np.float32) + np.asarray(center, np.float32)
    return v.astype(np.float32), f


def meshes(spec: dict):
    """(file name, vertices, faces) of the set, in the order of its organs."""
    for i, (stem, radii, center, target) in enumerate(spec["organs"]):
        yield f"{stem}.obj", *organ_mesh(radii, center, spec["tris_scale"] * target,
                                         spec["seed_base"] + i)
