"""Carry the reference's state into the port's tensors.

``from_reference`` takes what the JAX package renders from, as numpy
arrays — the scene tables of ``ScenePack.trace_tables()``, the probe pose,
the ``(M, 8)`` material table, the two texture seeds
(``make_texture_volume(...)["seeds"]``) and optionally the per-bounce draws
of ``physics.draw_bounce_randoms`` — and returns the port's tensors on
``device`` (a required keyword: nothing picks the CPU on its own). With
the same draws and seeds the port computes the reference's frame (as it
does from the frame's seed alone: ``utils/rng.py`` derives both as the
reference does). A ``CulledTris``
the reference packed (``ops/pallas/intersect.py:pack_tris_culled``) comes
across as the port's ``clusters.CulledTris``, table for table.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import clusters
from ..ops.geometry import triangle_soa


def culled_from_reference(packed, *, device) -> clusters.CulledTris:
    """The port's ``CulledTris`` holding the tables of the reference's."""
    tables = {f: getattr(packed, f) for f in clusters._ARRAY_FIELDS + clusters._STATIC_FIELDS}
    return clusters.CulledTris.from_arrays(tables, tables, device)


def from_reference(pack_or_arrays, materials, volume_seeds, draws=None, *, culled=None,
                   device):
    """``pack_or_arrays`` is a ScenePack (of either package) or a dict with
    its fields: tris, tri_mesh_id, mesh_mat_inside, mesh_mat_outside,
    mesh_is_vascular, spacing, starting_material, transducer_position and
    transducer_angles. Returns a dict: ``scene`` (the tracer's tables, with the
    triangles as a (9, T) v0/e1/e2 SoA), ``materials``, ``spacing``,
    ``starting_material`` (int), ``position``, ``angles``, ``seeds`` (a (2,)
    int64 tensor kept on the CPU: the kernels read it on the host) and, if
    given, ``draws`` (dict of (D, N) float32 tensors) and ``culled`` (the
    reference's ``CulledTris`` as the port's)."""
    src = pack_or_arrays
    get = src.__getitem__ if isinstance(src, dict) else lambda k: getattr(src, k)

    def tensor(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    out = {
        "scene": {
            "tri_soa": triangle_soa(tensor(get("tris"), torch.float32)),
            "tri_mesh_id": tensor(get("tri_mesh_id"), torch.int32),
            "mesh_mat_inside": tensor(get("mesh_mat_inside"), torch.int32),
            "mesh_mat_outside": tensor(get("mesh_mat_outside"), torch.int32),
            "mesh_is_vascular": tensor(get("mesh_is_vascular"), torch.bool),
        },
        "materials": tensor(materials, torch.float32),
        "spacing": tensor(get("spacing"), torch.float32),
        "starting_material": int(get("starting_material")),
        "position": tensor(get("transducer_position"), torch.float32),
        "angles": tensor(get("transducer_angles"), torch.float32),
        "seeds": torch.as_tensor(np.asarray(volume_seeds).astype(np.int64)),
    }
    if draws is not None:
        out["draws"] = {k: tensor(v, torch.float32) for k, v in draws.items()}
    if culled is not None:
        out["culled"] = culled_from_reference(culled, device=device)
    return out
