"""Mesh sets are found by name: a configuration's ``meshes.kind`` names
``meshsets/<kind>.py``, whose set ``harness/meshes.py:ensure`` writes before
the program or the reference reads it. The sphere phantom's files are pinned
byte for byte, and a kind added as a new file runs with no other file
edited."""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import pytest

from benchmark.harness import cell, meshes, runner
from benchmark.reference import scene as ref_scene
from benchmark.tests.helpers import SMALL, setup

# the sphere phantom's files as the writer made them before mesh sets were found by name
SPHERE_BOX_SHA256 = {
    "BOX.obj": "ae429e0b59718b13a44d23c37953bd12769db936f5efbc5be5f8a98070d937ef",
    "SPHERE.obj": "a6e83e9fb919483afde86d0cadd2d02691d684b3a8e10b5d42d1e5152f1b5517",
}

# a mesh kind of two tetrahedra, as a later configuration would add it: a file of its own
TWO_TETRA = '''
import numpy as np


def tetra(size):
    v = size * np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]], np.float32)
    f = np.array([[0, 1, 2], [0, 3, 1], [0, 2, 3], [1, 3, 2]], np.int32)
    return v, f


def meshes(spec):
    yield "OUTER.obj", *tetra(spec["outer"])
    yield "INNER.obj", *tetra(spec["inner"])
'''


def digests(directory) -> dict[str, str]:
    return {name: hashlib.sha256(open(os.path.join(directory, name), "rb").read()).hexdigest()
            for name in sorted(os.listdir(directory))}


@pytest.mark.parametrize("config", ["sphere", "sphere_soft"])
def test_sphere_box_writes_the_pinned_files(config, tmp_path):
    directory = meshes.ensure(cell.config(config)["meshes"], str(tmp_path / config))
    assert digests(directory) == SPHERE_BOX_SHA256


def test_an_unknown_kind_names_the_folder(tmp_path):
    with pytest.raises(ValueError, match=r"'no_such_kind'.*benchmark/meshsets/"):
        meshes.ensure({"kind": "no_such_kind"}, str(tmp_path))
    assert os.listdir(tmp_path) == []


def test_a_kind_added_as_a_new_file_is_found_and_read_by_both_sides(tmp_path, monkeypatch):
    from mcray_tpu_torch.scene.compile import load_and_compile

    bench = tmp_path / "bench"
    (bench / "meshsets").mkdir(parents=True)
    (bench / "meshsets" / "two_tetra.py").write_text(TWO_TETRA)
    monkeypatch.setattr(cell, "BENCH", str(bench))
    mesh_dir = meshes.ensure({"kind": "two_tetra", "outer": 3.0, "inner": 1.0},
                             str(tmp_path / "meshes"))
    assert sorted(os.listdir(mesh_dir)) == ["INNER.obj", "OUTER.obj"]

    with open(os.path.join(cell.ROOT, "assets", "sphere", "sphere.scene")) as f:
        spec = json.load(f)
    spec["meshes"] = [{**spec["meshes"][0], "file": "OUTER.obj"},
                      {**spec["meshes"][1], "file": "INNER.obj"}]
    scene_path = tmp_path / "two.scene"
    scene_path.write_text(json.dumps(spec))

    reference = ref_scene.load(str(scene_path), mesh_dir)
    program = load_and_compile(str(scene_path), asset_dir=mesh_dir)
    assert reference.tris.shape == program.tris.shape == (8, 3, 3)
    np.testing.assert_array_equal(reference.tris, program.tris)
    np.testing.assert_array_equal(reference.tri_mesh_id, [0] * 4 + [1] * 4)
    np.testing.assert_array_equal(program.tri_mesh_id, reference.tri_mesh_id)
    # the program read the benchmark's set and filled in nothing of its own
    assert sorted(os.listdir(mesh_dir)) == ["INNER.obj", "OUTER.obj"]


def test_setup_gives_the_sphere_as_before():
    _, sim, ref = setup("sphere")
    assert digests(os.path.join(runner.MESH_ROOT, "sphere")) == SPHERE_BOX_SHA256
    assert sim.intersect == "listed" and sim.pack.n_triangles == 2220
    np.testing.assert_array_equal(ref.scene.tris, sim.pack.tris)
    np.testing.assert_array_equal(ref.scene.tri_mesh_id, sim.pack.tri_mesh_id)


@pytest.mark.parametrize("closest_hit", ["bvh", "listed", "grouped"])
def test_the_closest_hit_of_a_configuration(closest_hit):
    conf = {**cell.config("sphere"), "closest_hit": closest_hit}
    mesh_dir = meshes.ensure(conf["meshes"], os.path.join(runner.MESH_ROOT, conf["name"]))
    sim = runner.simulator(conf, {**conf["acquisition"], **SMALL},
                           os.path.join(cell.ROOT, conf["scene"]), mesh_dir, 1234, "cpu")
    assert sim.intersect == closest_hit
