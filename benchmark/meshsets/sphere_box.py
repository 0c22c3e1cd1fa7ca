"""Mesh kind ``sphere_box``: the sphere scene's phantom.

The sphere scene's OBJ files are not shipped (the reference repository
keeps them outside); these are the phantom the scene was built around: its
box (half-extent 6) and sphere (radius 2.5, 24 x 48). A configuration's
``meshes`` entry: ``{"kind": "sphere_box", "box_half_extent": ...,
"sphere_radius": ..., "sphere_subdivision": [n_theta, n_phi]}``.
"""

from __future__ import annotations

import numpy as np


def box_mesh(half_extent: float):
    h = half_extent
    v = np.array([[-h, -h, -h], [h, -h, -h], [h, h, -h], [-h, h, -h],
                  [-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h]], np.float32)
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                  [3, 6, 2], [3, 7, 6], [0, 7, 3], [0, 4, 7], [1, 2, 6], [1, 6, 5]], np.int32)
    return v, f


def sphere_mesh(radius: float, n_theta: int, n_phi: int):
    """UV sphere about the origin, outward windings."""
    verts = [np.array([0, 0, radius]), np.array([0, 0, -radius])]
    ring_start = []
    for i in range(1, n_theta):
        th = np.pi * i / n_theta
        ring_start.append(len(verts))
        for j in range(n_phi):
            ph = 2 * np.pi * j / n_phi
            verts.append(radius * np.array([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                                            np.cos(th)]))
    v = np.asarray(verts, np.float32)
    f = [[0, ring_start[0] + j, ring_start[0] + (j + 1) % n_phi] for j in range(n_phi)]
    for i in range(len(ring_start) - 1):
        a, b = ring_start[i], ring_start[i + 1]
        for j in range(n_phi):
            j2 = (j + 1) % n_phi
            f.append([a + j, b + j, b + j2])
            f.append([a + j, b + j2, a + j2])
    last = ring_start[-1]
    f += [[1, last + (j + 1) % n_phi, last + j] for j in range(n_phi)]
    return v, np.asarray(f, np.int32)


def meshes(spec: dict):
    """(file name, vertices, faces) of the set."""
    yield "BOX.obj", *box_mesh(spec["box_half_extent"])
    yield "SPHERE.obj", *sphere_mesh(spec["sphere_radius"], *spec["sphere_subdivision"])
