"""`.scene` JSON parsing.

Accepts the reference's schema verbatim (reference: src/scene.cpp:185-247)
with two deliberate leniencies documented in SURVEY.md §5: missing
``shininess``/``thickness`` material fields default to 0 (so the pre-revision
``ircad11.scene`` parses instead of throwing), and ``workingDirectory`` may be
overridden so scenes run against local assets.
"""

from __future__ import annotations

import dataclasses
import json
import os

MATERIAL_FIELDS = (
    "impedance",
    "attenuation",
    "mu0",
    "mu1",
    "sigma",
    "specularity",
    "shininess",
    "thickness",
)


@dataclasses.dataclass(frozen=True)
class Material:
    """Acoustic material — exact field set of the reference (src/mesh.h:7-10)."""

    name: str
    impedance: float
    attenuation: float
    mu0: float
    mu1: float
    sigma: float
    specularity: float
    shininess: float = 0.0
    thickness: float = 0.0

    def as_row(self):
        return [getattr(self, f) for f in MATERIAL_FIELDS]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """One scene mesh entry (src/scene.cpp:227-246, src/mesh.h:12-20)."""

    filename: str
    is_rigid: bool
    is_vascular: bool
    deltas: tuple[float, float, float]
    outside_normals: bool
    material: str
    outside_material: str


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    working_dir: str
    transducer_position: tuple[float, float, float]
    transducer_angles: tuple[float, float, float]
    origin: tuple[float, float, float]
    spacing: tuple[float, float, float]
    scaling: float
    starting_material: str
    materials: tuple[Material, ...]
    meshes: tuple[MeshSpec, ...]

    @property
    def material_names(self) -> list[str]:
        return [m.name for m in self.materials]

    def material_id(self, name: str) -> int:
        return self.material_names.index(name)


def load_scene(path: str, working_dir: str | None = None) -> SceneSpec:
    with open(path) as f:
        cfg = json.load(f)
    return parse_scene(cfg, working_dir=working_dir, scene_dir=os.path.dirname(path))


def parse_scene(cfg: dict, working_dir: str | None = None, scene_dir: str = "") -> SceneSpec:
    mats = []
    for m in cfg["materials"]:
        mats.append(
            Material(
                name=m["name"],
                impedance=float(m["impedance"]),
                attenuation=float(m["attenuation"]),
                mu0=float(m["mu0"]),
                mu1=float(m["mu1"]),
                sigma=float(m["sigma"]),
                specularity=float(m["specularity"]),
                shininess=float(m.get("shininess", 0.0)),
                thickness=float(m.get("thickness", 0.0)),
            )
        )
    names = [m.name for m in mats]

    meshes = []
    for me in cfg["meshes"]:
        if me["material"] not in names or me["outsideMaterial"] not in names:
            raise ValueError(f"mesh {me['file']}: unknown material")
        d = me["deltas"]
        meshes.append(
            MeshSpec(
                filename=me["file"],
                is_rigid=bool(me["rigid"]),
                is_vascular=bool(me["vascular"]),
                deltas=(float(d[0]), float(d[1]), float(d[2])),
                outside_normals=bool(me["outsideNormals"]),
                material=me["material"],
                outside_material=me["outsideMaterial"],
            )
        )

    if working_dir is None:
        wd = cfg.get("workingDirectory", "")
        # The shipped scenes hardcode the original author's home directory;
        # fall back to the scene file's own directory when that path is absent.
        if not wd or not os.path.isdir(wd):
            wd = scene_dir
    else:
        wd = working_dir

    t_pos = cfg["transducerPosition"]
    t_ang = cfg.get("transducerAngles", [0.0, 0.0, 0.0])
    orig = cfg["origin"]
    spac = cfg["spacing"]
    sm = cfg["startingMaterial"]
    if sm not in names:
        raise ValueError(f"unknown startingMaterial {sm}")

    return SceneSpec(
        working_dir=wd,
        transducer_position=(float(t_pos[0]), float(t_pos[1]), float(t_pos[2])),
        transducer_angles=(float(t_ang[0]), float(t_ang[1]), float(t_ang[2])),
        origin=(float(orig[0]), float(orig[1]), float(orig[2])),
        spacing=(float(spac[0]), float(spac[1]), float(spac[2])),
        scaling=float(cfg["scaling"]),
        starting_material=sm,
        materials=tuple(mats),
        meshes=tuple(meshes),
    )
