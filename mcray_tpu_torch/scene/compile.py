"""Scene compiler: SceneSpec -> packed numpy tables (ScenePack).

Port of ``mcray_tpu/scene/compile.py:27-130``. The whole scene becomes one
flat world-space triangle soup plus small per-mesh/material tables; the
per-mesh transform matches Bullet's (local scaling, then translation to
``deltas * scaling^2 + origin``, reference src/scene.cpp:313-324). With
``with_bvh`` (the default) the pack carries the flat BVH whose depth-first
triangle order the cluster packing follows (``ops/clusters.py``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..ops.bvh import FlatBVH, build_bvh
from . import primitives
from .loader import SceneSpec, load_scene
from .obj import load_obj


@dataclasses.dataclass
class ScenePack:
    """Packed scene, all numpy on the host."""

    tris: np.ndarray              # (T, 3, 3) f32 world-space triangles
    tri_mesh_id: np.ndarray       # (T,) i32
    materials: np.ndarray         # (M, 8) f32 [Z, att, mu0, mu1, sigma, spec, shin, thick]
    mesh_mat_inside: np.ndarray   # (K,) i32 material id
    mesh_mat_outside: np.ndarray  # (K,) i32
    mesh_is_vascular: np.ndarray  # (K,) bool
    starting_material: int
    transducer_position: np.ndarray  # (3,) f32
    transducer_angles: np.ndarray    # (3,) f32 degrees
    spacing: np.ndarray              # (3,) f32
    bvh: FlatBVH | None = None

    @property
    def n_triangles(self) -> int:
        return int(self.tris.shape[0])

    @property
    def n_materials(self) -> int:
        return int(self.materials.shape[0])

    def trace_tables(self) -> dict[str, np.ndarray]:
        """The static (non-differentiable) arrays the tracer reads."""
        return {
            "tris": self.tris,
            "tri_mesh_id": self.tri_mesh_id,
            "mesh_mat_inside": self.mesh_mat_inside,
            "mesh_mat_outside": self.mesh_mat_outside,
            "mesh_is_vascular": self.mesh_is_vascular,
        }


def compile_scene(spec: SceneSpec, *, asset_dir: str | None = None,
                  with_bvh: bool = True) -> ScenePack:
    asset_dir = asset_dir or spec.working_dir
    all_tris, all_mid = [], []
    inside, outside, vascular = [], [], []
    for k, mesh in enumerate(spec.meshes):
        path = os.path.join(asset_dir, mesh.filename)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"mesh asset {path} not found; generate fixtures with "
                "mcray_tpu_torch.scene.primitives.ensure_assets / ensure_ircad_assets"
            )
        verts, faces = load_obj(path)
        s = spec.scaling
        pos = np.asarray(mesh.deltas, np.float32) * s * s + np.asarray(spec.origin, np.float32)
        world = verts * s + pos
        tris = world[faces]  # (F, 3, 3)
        all_tris.append(tris.astype(np.float32))
        all_mid.append(np.full((tris.shape[0],), k, np.int32))
        inside.append(spec.material_id(mesh.material))
        outside.append(spec.material_id(mesh.outside_material))
        vascular.append(mesh.is_vascular)

    tris = np.concatenate(all_tris, 0) if all_tris else np.zeros((0, 3, 3), np.float32)
    tri_mesh_id = np.concatenate(all_mid, 0) if all_mid else np.zeros((0,), np.int32)
    pack = ScenePack(
        tris=tris,
        tri_mesh_id=tri_mesh_id,
        materials=np.asarray([m.as_row() for m in spec.materials], np.float32),
        mesh_mat_inside=np.asarray(inside, np.int32),
        mesh_mat_outside=np.asarray(outside, np.int32),
        mesh_is_vascular=np.asarray(vascular, bool),
        starting_material=spec.material_id(spec.starting_material),
        transducer_position=np.asarray(spec.transducer_position, np.float32),
        transducer_angles=np.asarray(spec.transducer_angles, np.float32),
        spacing=np.asarray(spec.spacing, np.float32),
    )
    if with_bvh and tris.shape[0] > 0:
        pack.bvh = build_bvh(tris, tri_mesh_id)
    return pack


def load_and_compile(scene_path: str, *, asset_dir: str | None = None,
                     with_bvh: bool = True) -> ScenePack:
    """Load a ``.scene`` file, generating the shipped phantom meshes on first use."""
    spec = load_scene(scene_path)
    asset_dir = asset_dir or spec.working_dir
    needed = {m.filename for m in spec.meshes}
    missing = [f for f in needed if not os.path.exists(os.path.join(asset_dir, f))]
    if missing:
        if {"BOX.obj", "SPHERE.obj"} & set(missing):
            primitives.ensure_assets(asset_dir)
        elif "mega" in os.path.basename(os.path.normpath(asset_dir)):
            primitives.ensure_ircad_mega_assets(asset_dir)
        elif "hd" in os.path.basename(os.path.normpath(asset_dir)):
            primitives.ensure_ircad_hd_assets(asset_dir)
        else:
            primitives.ensure_ircad_assets(asset_dir)
    return compile_scene(spec, asset_dir=asset_dir, with_bvh=with_bvh)
