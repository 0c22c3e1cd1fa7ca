"""The configurations' meshes, made by the benchmark from their parameters
and written as OBJ files that the program and the reference both read.

The sphere scene's OBJ files are not shipped (the reference repository
keeps them outside); these are the phantom the scene was built around: its
box (half-extent 6) and sphere (radius 2.5, 24 x 48). A set is written once
into its directory under the checkout and read from there by every later
run.
"""

from __future__ import annotations

import os

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


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Write the OBJ beside its final name, then move it there."""
    tmp = f"{path}.partial"
    with open(tmp, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in faces:
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")
    os.replace(tmp, path)


def meshes(spec: dict):
    """(file name, vertices, faces) of a configuration's ``meshes`` entry:
    ``{"kind": "sphere_box", ...}``."""
    if spec["kind"] == "sphere_box":
        yield "BOX.obj", *box_mesh(spec["box_half_extent"])
        yield "SPHERE.obj", *sphere_mesh(spec["sphere_radius"], *spec["sphere_subdivision"])
    else:
        raise ValueError(f"unknown mesh kind {spec['kind']!r}")


def ensure(spec: dict, directory: str) -> str:
    """Write the meshes of ``spec`` into ``directory`` where absent; return it."""
    os.makedirs(directory, exist_ok=True)
    for name, v, f in meshes(spec):
        path = os.path.join(directory, name)
        if not os.path.exists(path):
            save_obj(path, v, f)
    return directory
