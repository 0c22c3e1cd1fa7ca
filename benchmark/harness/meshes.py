"""The configurations' meshes, made by the benchmark from their parameters
and written as OBJ files that the program and the reference both read.

A configuration's ``meshes`` entry names its kind: ``{"kind": "<kind>",
...}``. The kind's generator is ``meshsets/<kind>.py``, found by that name,
whose ``meshes(spec)`` yields (file name, vertices, faces) from the entry. A
set is written once into its directory under the checkout, before the
program or the reference reads it, and read from there by every later run.
"""

from __future__ import annotations

import os

import numpy as np

from . import cell


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
    """(file name, vertices, faces) of a configuration's ``meshes`` entry,
    from ``meshsets/<spec["kind"]>.py``."""
    kind = spec["kind"]
    folder = os.path.join(cell.BENCH, "meshsets")
    if not os.path.isfile(os.path.join(folder, f"{kind}.py")):
        raise ValueError(f"unknown mesh kind {kind!r}: no {kind}.py in "
                         f"{os.path.relpath(folder, cell.ROOT)}/")
    return cell.module("meshsets", kind).meshes(spec)


def ensure(spec: dict, directory: str) -> str:
    """Write the meshes of ``spec`` into ``directory`` where absent; return it."""
    os.makedirs(directory, exist_ok=True)
    for name, v, f in meshes(spec):
        path = os.path.join(directory, name)
        if not os.path.exists(path):
            save_obj(path, v, f)
    return directory
