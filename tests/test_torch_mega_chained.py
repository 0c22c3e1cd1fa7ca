"""The ``mega.chained`` cell's configuration on the CPU, at small sizes: the
benchmark's frozen organ generator (``benchmark/meshsets/bumpy_organs.py``)
is the port's ``bumpy_organ_mesh`` bit for bit; on the 11-organ scene from
that set cut to ~3k triangles (still the listed closest hit) at the
benchmark's small acquisition, the port's chained batch is the benchmark
reference's frames of its keys within the cell's limit and a frame of it
is bitwise its eager ``render_frames``; set-up spans the cluster packing
once a ``Simulator``; and the program's own mesh fill-in never runs where
the benchmark wrote the set. ~10 s."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from benchmark.harness import cell, check, meshes, runner
from benchmark.reference.frame import Reference, chained_keys
from benchmark.tests.helpers import SMALL
from mcray_tpu_torch.config import SimConfig
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.scene import primitives
from mcray_tpu_torch.scene.compile import load_and_compile
from mcray_tpu_torch.utils import profiling

#: the organ targets scaled to ~3k triangles in all: past the listed mode's 2,048
SMALL_SCALE = 0.02
SMALL_TRIANGLES, SMALL_CLUSTERS = 3296, 32
TEXTURE_SEED, SEED0 = 1234, 2**31 + 77
FILL_INS = ("ensure_assets", "ensure_ircad_assets", "ensure_ircad_hd_assets",
            "ensure_ircad_mega_assets")


class FillIn(AssertionError):
    """The program generated meshes of its own."""


def refuse_fill_ins(mp: pytest.MonkeyPatch) -> None:
    def refuse(asset_dir):
        raise FillIn(f"the program filled in meshes in {asset_dir}")

    for name in FILL_INS:
        mp.setattr(primitives, name, refuse)


def small_spec() -> dict:
    return {**cell.config("mega")["meshes"], "tris_scale": SMALL_SCALE}


@pytest.fixture(scope="module")
def mega(tmp_path_factory):
    """(acquisition, mesh directory, scene path) of the cut set."""
    conf = cell.config("mega")
    mesh_dir = meshes.ensure(small_spec(), str(tmp_path_factory.mktemp("meshes") / "mega"))
    return {**conf["acquisition"], **SMALL}, mesh_dir, os.path.join(cell.ROOT, conf["scene"])


def built(acq, scene, mesh_dir, **choice):
    """(the Simulator, its ``simulator.clusters`` spans), built listed as a
    run builds it (``choice``: other closest hits), with every fill-in
    refused."""
    n_spans = len(profiling.spans())
    with pytest.MonkeyPatch.context() as mp:
        refuse_fill_ins(mp)
        sim = Simulator(load_and_compile(scene, asset_dir=mesh_dir), SimConfig(**acq),
                        device="cpu", seed=TEXTURE_SEED,
                        intersect_mode=cell.config("mega")["closest_hit"], **choice)
    spans = [s for s in profiling.spans()[n_spans:] if s.name == "simulator.clusters"]
    return sim, spans


@pytest.mark.parametrize("organ", range(11))
def test_the_frozen_generator_is_the_ports_bit_for_bit(organ):
    spec = small_spec()
    name, v, f = list(cell.module("meshsets", "bumpy_organs").meshes(spec))[organ]
    stem, radii, center, _ = primitives._IRCAD_ORGANS[organ]
    target = primitives._IRCAD_HD_TRIS[stem]
    assert spec["organs"][organ] == [stem, list(radii), list(center), target]
    assert name == f"{stem}.obj"
    pv, pf = primitives.bumpy_organ_mesh(radii, center, SMALL_SCALE * target, seed=100 + organ)
    assert v.dtype == pv.dtype and f.dtype == pf.dtype
    np.testing.assert_array_equal(v.view(np.uint32), pv.view(np.uint32))
    np.testing.assert_array_equal(f, pf)


def test_the_chained_batch_is_the_references_and_a_frame_its_eager_one(mega):
    acq, mesh_dir, scene = mega
    sim, _ = built(acq, scene, mesh_dir)
    assert sim.intersect == "listed" and sim.pack.n_triangles == SMALL_TRIANGLES
    assert len(sim.pack.mesh_mat_inside) == 11
    out = sim.make_chained_batch(2, 2)(SEED0)
    keys = chained_keys(SEED0, 2, 1, "cpu")
    reference = Reference(acq, scene, mesh_dir, TEXTURE_SEED, "cpu")
    np.testing.assert_array_equal(reference.scene.tris, sim.pack.tris)
    gaps = check.rel_l2(out, reference.render(keys)["bmode"])
    assert max(gaps) <= cell.limits("mega.chained")["rel_l2_max"], gaps
    assert float(out.std()) > 0
    assert torch.equal(sim.render_frames(keys[1:2])["bmode"][0], out[1])


@pytest.mark.parametrize("scene_name, choice, clusters", [
    ("mega", {}, SMALL_CLUSTERS),
    ("sphere", {}, 24),
    ("sphere", {"use_culled_intersect": False}, 0),
], ids=["mega listed", "sphere listed", "sphere brute"])
def test_set_up_spans_the_cluster_packing_once(mega, scene_name, choice, clusters):
    if scene_name == "mega":
        acq, mesh_dir, scene = mega
        want = (SMALL_TRIANGLES, 11)
    else:
        conf = cell.config("sphere")
        acq = {**conf["acquisition"], **SMALL}
        mesh_dir = meshes.ensure(conf["meshes"], os.path.join(runner.MESH_ROOT, "sphere"))
        scene = os.path.join(cell.ROOT, conf["scene"])
        want = (2220, 2)
    sim, spans = built(acq, scene, mesh_dir, **choice)
    assert (sim.pack.n_triangles, len(sim.pack.mesh_mat_inside)) == want
    if clusters:
        assert sim.culled_tris[0].aabb_cluster.shape[0] == sim.culled_tris[0].n_clusters == clusters
        assert len(spans) == 1 and spans[0].end_ns >= spans[0].start_ns
    else:
        assert sim.culled_tris is None and spans == []


def test_a_missing_mesh_would_reach_the_refused_fill_in(mega, tmp_path):
    _, mesh_dir, scene = mega
    partial = tmp_path / "mega"
    partial.mkdir()
    for name in sorted(os.listdir(mesh_dir))[1:]:
        (partial / name).write_bytes(open(os.path.join(mesh_dir, name), "rb").read())
    with pytest.MonkeyPatch.context() as mp:
        refuse_fill_ins(mp)
        with pytest.raises(FillIn):
            load_and_compile(scene, asset_dir=str(partial))
