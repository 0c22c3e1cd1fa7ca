"""The scene as the reference traces it, derived from the ``.scene`` file and
its OBJ meshes alone: the world-space triangles and the mesh and material
tables, the flat BVH (a median split on the longest centroid axis, leaves of
four), and the triangle clusters the listed closest hit walks (BVH order, cut
into clusters of ``tile_t``, the clusters sorted nearest-first to the probe,
each with its box, padded to a multiple of the super-cluster width with far
empty clusters).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

MATERIAL_FIELDS = ("impedance", "attenuation", "mu0", "mu1", "sigma", "specularity",
                   "shininess", "thickness")
FAR = 1e30
SOA_ROWS = 16
SUPER_G = 8


@dataclasses.dataclass
class Scene:
    tris: np.ndarray              # (T, 3, 3) f32 world space
    tri_mesh_id: np.ndarray       # (T,) i32
    materials: np.ndarray         # (M, 8) f32
    mesh_mat_inside: np.ndarray   # (K,) i32
    mesh_mat_outside: np.ndarray  # (K,) i32
    mesh_is_vascular: np.ndarray  # (K,) bool
    starting_material: int
    position: np.ndarray          # (3,) f32, the probe
    angles: np.ndarray            # (3,) f32 degrees
    spacing: np.ndarray           # (3,) f32
    bvh_nodes: np.ndarray         # (N, 6) f32
    bvh_meta: np.ndarray          # (N, 2) i32
    bvh_order: np.ndarray         # (T,) i32


def read_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(vertices (V, 3) f32, faces (F, 3) i32), polygons fan-triangulated."""
    verts, faces = [], []
    with open(path, errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                verts.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))
    return (np.asarray(verts, np.float32).reshape(-1, 3),
            np.asarray(faces, np.int32).reshape(-1, 3))


def load(scene_path: str, mesh_dir: str) -> Scene:
    """The scene of ``scene_path`` with its meshes read from ``mesh_dir``."""
    with open(scene_path) as f:
        spec = json.load(f)
    names = [m["name"] for m in spec["materials"]]
    materials = np.asarray([[float(m.get(k, 0.0)) for k in MATERIAL_FIELDS]
                            for m in spec["materials"]], np.float32)
    s = float(spec["scaling"])
    origin = np.asarray([float(v) for v in spec["origin"]], np.float32)
    all_tris, all_mid, inside, outside, vascular = [], [], [], [], []
    for k, mesh in enumerate(spec["meshes"]):
        verts, faces = read_obj(os.path.join(mesh_dir, mesh["file"]))
        pos = np.asarray([float(v) for v in mesh["deltas"]], np.float32) * s * s + origin
        tris = (verts * s + pos)[faces]
        all_tris.append(tris.astype(np.float32))
        all_mid.append(np.full((tris.shape[0],), k, np.int32))
        inside.append(names.index(mesh["material"]))
        outside.append(names.index(mesh["outsideMaterial"]))
        vascular.append(bool(mesh["vascular"]))
    tris = np.concatenate(all_tris, 0)
    nodes, meta, order = build_bvh(tris)
    return Scene(
        tris=tris, tri_mesh_id=np.concatenate(all_mid, 0), materials=materials,
        mesh_mat_inside=np.asarray(inside, np.int32),
        mesh_mat_outside=np.asarray(outside, np.int32),
        mesh_is_vascular=np.asarray(vascular, bool),
        starting_material=names.index(spec["startingMaterial"]),
        position=np.asarray([float(v) for v in spec["transducerPosition"]], np.float32),
        angles=np.asarray([float(v) for v in spec.get("transducerAngles", [0, 0, 0])],
                          np.float32),
        spacing=np.asarray([float(v) for v in spec["spacing"]], np.float32),
        bvh_nodes=nodes, bvh_meta=meta, bvh_order=order)


def build_bvh(tris: np.ndarray, leaf_size: int = 4):
    """Depth-first flat BVH: nodes (N, 6) [min, max], meta (N, 2) (inner:
    (right child, -1), the left child next; leaf: (first, count) into the
    order), the triangle order (T,)."""
    lo, hi = tris.min(axis=1), tris.max(axis=1)
    centroid = (lo + hi) * 0.5
    nodes, meta, order = [], [], []

    def emit(idx: np.ndarray) -> int:
        me = len(nodes)
        nodes.append([*lo[idx].min(axis=0), *hi[idx].max(axis=0)])
        meta.append([0, 0])
        if idx.size <= leaf_size:
            meta[me] = [len(order), idx.size]
            order.extend(int(i) for i in idx)
            return me
        c = centroid[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        part = np.argsort(c[:, axis], kind="stable")
        half = idx.size // 2
        emit(idx[part[:half]])
        meta[me] = [emit(idx[part[half:]]), -1]
        return me

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        emit(np.arange(tris.shape[0]))
    finally:
        sys.setrecursionlimit(old)
    return (np.asarray(nodes, np.float32), np.asarray(meta, np.int32),
            np.asarray(order, np.int32))


@dataclasses.dataclass
class Clusters:
    tiles: torch.Tensor     # (n_clusters, 16, tile_t): v0, e1, e2 rows, then the box
    boxes: torch.Tensor     # (n_clusters, 8): [min, max, 0, 0]
    slot_all: torch.Tensor  # (n_slots, 10): v0, e1, e2, mesh id
    n_slots: int
    tile_t: int


def pack_clusters(scene: Scene, tile_t: int, device) -> Clusters:
    """The clusters of ``tile_t`` triangles the listed closest hit walks."""
    tris, t = scene.tris, scene.tris.shape[0]
    order = np.asarray(scene.bvh_order)
    if t > tile_t:
        cent = tris[order].mean(axis=1)
        keys = np.empty((-(-t // tile_t),), np.float32)
        for c in range(keys.shape[0]):
            keys[c] = np.linalg.norm(cent[c * tile_t:(c + 1) * tile_t].mean(axis=0)
                                     - scene.position)
        order = np.concatenate([order[c * tile_t:(c + 1) * tile_t]
                                for c in np.argsort(keys, kind="stable")])
    tris_o = tris[order]
    n_slots = t + (-t) % tile_t
    n_real = n_slots // tile_t
    v0, e1, e2 = tris_o[:, 0], tris_o[:, 1] - tris_o[:, 0], tris_o[:, 2] - tris_o[:, 0]
    box = np.zeros((n_real, 8), np.float32)
    for c in range(n_real):
        chunk = tris_o[c * tile_t:(c + 1) * tile_t].reshape(-1, 3)
        box[c, 0:3], box[c, 3:6] = chunk.min(axis=0), chunk.max(axis=0)
    soa = np.zeros((SOA_ROWS, n_slots), np.float32)
    soa[0:3, :t], soa[3:6, :t], soa[6:9, :t] = v0.T, e1.T, e2.T
    soa[9:15] = np.repeat(box[:, 0:6].T, tile_t, axis=1)
    slot_all = np.zeros((n_slots, 10), np.float32)
    slot_all[:t, 0:3], slot_all[:t, 3:6], slot_all[:t, 6:9] = v0, e1, e2
    slot_all[:, 9] = -1.0
    slot_all[:t, 9] = scene.tri_mesh_id[order]
    super_g = max(SUPER_G, int(2 ** np.ceil(np.log2(max(n_real / 256.0, 1.0)))))
    n_clusters = -(-n_real // super_g) * super_g
    tiles = np.zeros((n_clusters, SOA_ROWS, tile_t), np.float32)
    tiles[:n_real] = soa.reshape(SOA_ROWS, n_real, tile_t).transpose(1, 0, 2)
    tiles[n_real:, 9:15] = FAR
    boxes = np.zeros((n_clusters, 8), np.float32)
    boxes[:, 0:6] = FAR
    boxes[:n_real] = box

    def tensor(a):
        return torch.as_tensor(a, device=device)

    return Clusters(tensor(tiles), tensor(boxes), tensor(slot_all), n_slots, tile_t)
