"""BVH traversal (K11's plain version) and the ``Scene`` facade, on the CPU.

- ``ops/bvh.py:bvh_intersect_closest`` against the reference's
  (``mcray_tpu/ops/bvh.py:121-212``, its jnp ``while_loop``) on random
  triangles and segments and on the sphere's own queries: ``hit`` bitwise,
  ``t`` at rtol 1e-5, atol 1e-7 (the reference's jitted Möller–Trumbore
  contracts to FMA, the port rounds every op), and the winner (mesh id,
  oriented normal at atol 1e-5) wherever ``t`` is unique, as
  ``tests/test_torch_intersect.py`` holds the brute closest hit.
- The plain traversal against the port's plain brute closest hit (K1's
  plain version): ``t`` and triangle index bitwise (padded boxes, the least
  (t, index) wins); the wrapper counts no launch on the CPU; the node and
  test counts add up. Seven bounce-1 rays of the full-size sphere frame that
  run in the fan's plane onto the sphere's equator: the port's traversal
  equals the brute closest hit; unpadded (the reference's slab test, in the
  port's rounding) it drops the box of the hit on three of them and takes
  the neighbouring triangle's, a hair farther. (The reference's jitted
  traversal rounds otherwise and finds these seven.)
- ``Simulator(use_bvh=True)`` on the CPU: the frame equals the brute frame
  bitwise (segments and images); the cluster path does not replace an
  explicit ``use_bvh``, an explicit ``use_culled_intersect`` does.
- ``Scene``: ``cast_rays`` equals ``trace_paths`` on the key's draws
  bitwise and the reference's ``cast_rays`` on the valid segments (rtol
  1e-5, atol 1e-5; a missing ray's far end, ~1e3 away, at rtol 1e-4);
  ``step``, ``distance``, ``distance_in_mm``, ``enlarge``, ``materials`` and
  ``n_triangles`` equal the reference's.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (SPHERE_SCENE, both_configs, random_segments, random_triangles, to_np,
                         to_torch)
from mcray_tpu.ops.bvh import bvh_intersect_closest as ref_bvh_intersect_closest
from mcray_tpu.scene.runtime import Scene as RefScene
from mcray_tpu_torch.config import small_test_config
from mcray_tpu_torch.models import simulator
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.ops import bvh, geometry
from mcray_tpu_torch.ops.cuda import bvh_intersect, intersect
from mcray_tpu_torch.scene.compile import load_and_compile
from mcray_tpu_torch.scene.runtime import Scene
from mcray_tpu_torch.utils import rng


@functools.lru_cache(maxsize=None)
def _sphere_frame(use_bvh: bool):
    cfg = small_test_config(transducer_elements=32, samples_per_element=1)
    sim = Simulator(load_and_compile(SPHERE_SCENE), cfg, device="cpu", use_bvh=use_bvh,
                    use_culled_intersect=None if use_bvh else False)
    return sim, sim.render_frame(4)


def _cases():
    rng_np = np.random.default_rng(5)
    tris, mid = random_triangles(rng_np, 700)
    o, s = random_segments(rng_np, 300)
    sim, out = _sphere_frame(False)
    rays = out["segments"]["rays"]
    sphere = torch.cat([rays[0], rays[1]], dim=1).T
    return {"random": (tris, mid, to_torch(o), to_torch(s)),
            "sphere": (sim.pack.tris, sim.pack.tri_mesh_id, sphere[:, :3].contiguous(),
                       sphere[:, 3:].contiguous())}


def _unique(o, s, tri_soa, t):
    """Rays whose winning t no other triangle reaches within 1e-5 relative."""
    t_all, ok = geometry._moller_trumbore(o[:, None], s[:, None], *(
        tri_soa[i : i + 3].T[None] for i in (0, 3, 6)))
    t_all = to_np(torch.where(ok, t_all, 2.0))
    return (t < 1.5) & ((np.abs(t_all - t[:, None]) <= 1e-5 * t[:, None]).sum(axis=1) == 1)


@pytest.mark.parametrize("case", ["random", "sphere"])
@pytest.mark.parametrize("builder", ["default", "median split"])
def test_plain_traversal_matches_reference(case, builder):
    tris, mid, o, s = _cases()[case]
    flat = bvh.build_bvh(tris) if builder == "default" else bvh._build_bvh_py(tris, 4)
    want = {k: np.asarray(v) for k, v in ref_bvh_intersect_closest(
        jnp.asarray(to_np(o)), jnp.asarray(to_np(s)), jnp.asarray(tris), jnp.asarray(mid),
        jnp.asarray(flat.nodes), jnp.asarray(flat.meta), jnp.asarray(flat.tri_order)).items()}
    got = {k: to_np(v) for k, v in bvh.bvh_intersect_closest(
        o, s, tris, mid, flat.nodes, flat.meta, flat.tri_order).items()}

    assert want["hit"].sum() > 20
    np.testing.assert_array_equal(got["hit"], want["hit"])
    np.testing.assert_allclose(got["t"], want["t"], rtol=1e-5, atol=1e-7)
    unique = _unique(o, s, geometry.triangle_soa(to_torch(tris)), got["t"])
    assert unique.sum() > 20
    np.testing.assert_array_equal(got["mesh_id"][unique], want["mesh_id"][unique])
    np.testing.assert_allclose(got["normal"][unique], want["normal"][unique], atol=1e-5)


@pytest.mark.parametrize("case", ["random", "sphere"])
def test_plain_traversal_equals_plain_brute(case):
    tris, mid, o, s = _cases()[case]
    tri_soa = geometry.triangle_soa(to_torch(tris))
    device_bvh = bvh.DeviceBVH.from_flat(bvh.build_bvh(tris), tri_soa)
    rays = torch.cat([o, s], dim=1).T.contiguous()
    before = bvh_intersect.launches
    best_t, best_i, counts = bvh_intersect.bvh_best(rays, device_bvh, counts=True)
    assert bvh_intersect.launches == before  # the CPU runs the plain version
    brute_t, brute_i = intersect.intersect_best_plain(rays, tri_soa)
    assert torch.equal(best_t, brute_t) and int((best_t < 1.5).sum()) > 20
    assert torch.equal(best_i, brute_i)
    # every ray pops the root; a test happens only in a leaf it entered
    popped, tested = counts
    assert bool((popped >= 1).all()) and int(tested.sum()) > 0
    assert bool((tested <= 4 * popped).all())


# bounce-1 queries of the full-size sphere frame (SimConfig(), seed 0) that
# run in the fan's plane (z ~ -1e-12, dz ~ -1e-10) onto the sphere's equator
# edges, as f32 bits: [origin xyz, segment xyz]
GRAZING_RAYS = [
    [3233602406, 1067047376, 2878209811, 1096200512, 1076122346, 2937556551],
    [3233598937, 1050914919, 2871252863, 1096437798, 1060163476, 2930696255],
    [3233599343, 3204570578, 2864385354, 1096410034, 3213629381, 2923931151],
    [3233600049, 3208255229, 2874029479, 1096361744, 3217574134, 2933659761],
    [3233600109, 3208519104, 2868723967, 1096357638, 3217855528, 2928093023],
    [3233601324, 3212929665, 2857670275, 1096274462, 3221927528, 2917328575],
    [3233603016, 3215336154, 2861833004, 1096158798, 3224442859, 2921206656],
]


def test_padded_boxes_keep_hits_on_a_face(monkeypatch):
    pack = load_and_compile(SPHERE_SCENE)
    rays = torch.from_numpy(np.array(GRAZING_RAYS, np.uint32).view(np.float32)).T.contiguous()
    tri_soa = geometry.triangle_soa(torch.from_numpy(pack.tris))
    brute_t, brute_i = intersect.intersect_best_plain(rays, tri_soa)
    assert bool((brute_t < 1.5).all())
    t, i = bvh.bvh_best_plain(rays, bvh.DeviceBVH.from_flat(pack.bvh, tri_soa))
    assert torch.equal(t, brute_t) and torch.equal(i, brute_i)
    # unpadded, the slab test closes before the hit on the face
    monkeypatch.setattr(bvh, "BOX_PAD", 0.0)
    t0, _ = bvh.bvh_best_plain(rays, bvh.DeviceBVH.from_flat(pack.bvh, tri_soa))
    missed = t0 != brute_t
    assert bool(missed.any()) and bool((t0[missed] > brute_t[missed]).all())


def test_plain_traversal_edge_cases():
    """No triangle, a leaf-only tree, dead rays (parked at 1e9, zero segment)."""
    rng_np = np.random.default_rng(2)
    tris, _ = random_triangles(rng_np, 3)
    o, s = random_segments(rng_np, 40)
    rays = to_torch(np.concatenate([o, s], axis=1)).T.contiguous()
    rays[:3, 20:], rays[3:, 20:] = 1e9, 0.0
    tri_soa = geometry.triangle_soa(to_torch(tris))
    leaf = bvh.DeviceBVH.from_flat(bvh.build_bvh(tris), tri_soa)
    assert leaf.nodes.shape[0] == 1 and int(leaf.meta[0, 1]) == 3
    t, j, counts = bvh.bvh_best_plain(rays, leaf, counts=True)
    brute_t, _ = intersect.intersect_best_plain(rays, tri_soa)
    assert torch.equal(t, brute_t)
    assert bool((t[20:] == geometry.NO_HIT_T).all()) and bool((counts[1, 20:] == 0).all())
    empty = bvh.DeviceBVH.from_flat(bvh._build_bvh_py(np.zeros((0, 3, 3), np.float32), 4),
                                    torch.zeros((9, 0)))
    t, j = bvh.bvh_best_plain(rays, empty)
    assert bool((t == geometry.NO_HIT_T).all()) and bool((j == 0).all())


def test_bvh_frame_equals_the_brute_frame():
    sim, out = _sphere_frame(True)
    brute_sim, want = _sphere_frame(False)
    assert sim.intersect == "bvh" and brute_sim.intersect == "brute"
    assert sim.culled_tris is None and sim.bvh is not None
    assert int(out["segments"]["valid"].sum()) > 40
    for key in ("valid", "media_id", "to", "reflected", "rays"):
        assert torch.equal(out["segments"][key], want["segments"][key]), key
    for key in ("rf_raw", "bmode"):
        assert torch.equal(out[key], want[key]), key


def test_use_bvh_is_kept_unless_clusters_are_asked_for():
    pack = load_and_compile(SPHERE_SCENE)
    cfg = small_test_config(transducer_elements=16, samples_per_element=1)
    assert pack.n_triangles >= 2048  # the default would be the listed cluster kernel
    assert Simulator(pack, cfg, device="cpu", use_bvh=True).intersect == "bvh"
    assert Simulator(pack, cfg, device="cpu", use_bvh=True,
                     use_culled_intersect=True).intersect == "listed"
    no_bvh = load_and_compile(SPHERE_SCENE, with_bvh=False)
    assert Simulator(no_bvh, cfg, device="cpu", use_bvh=True,
                     use_culled_intersect=False).intersect == "brute"


@pytest.fixture(scope="module")
def scenes():
    ref_cfg, cfg = both_configs(transducer_elements=32, samples_per_element=1)
    return RefScene(SPHERE_SCENE, ref_cfg), Scene(SPHERE_SCENE, cfg, device="cpu")


def test_scene_cast_rays(scenes):
    ref, port = scenes
    got = port.cast_rays(4)
    key = rng.prng_key(4)
    want = simulator.trace_paths(
        simulator.path_draws(key, port.cfg, "cpu"), torch.from_numpy(port.materials),
        torch.from_numpy(port.pack.transducer_position),
        torch.from_numpy(port.pack.transducer_angles), port._state["scene"],
        port._state["spacing"], port.pack.starting_material, port.cfg)
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    ref_segments = {k: np.asarray(v) for k, v in ref.cast_rays(jax.random.PRNGKey(4)).items()}
    valid = ref_segments["valid"]
    np.testing.assert_array_equal(to_np(got["valid"]), valid)
    assert valid.sum() > 40
    for name in ("from", "to", "direction", "reflected", "initial", "distance"):
        # a missing ray's far end lies max_ray_length (~1e3) away: 1e-4 there
        rtol = 1e-4 if name == "to" else 1e-5
        np.testing.assert_allclose(to_np(got[name])[valid], ref_segments[name][valid],
                                   rtol=rtol, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(to_np(got["media_id"])[valid], ref_segments["media_id"][valid])
    # a pose and materials of the caller's
    moved = port.cast_rays(key, position=port.pack.transducer_position + [0.0, 0.2, 0.0])
    assert not torch.equal(moved["from"], got["from"])


def test_scene_helpers_match_reference(scenes):
    ref, port = scenes
    port.step(1000.0)  # a no-op, as the reference's
    a, b = [0.0, 1.0, -2.0], [1.5, -0.5, 3.0]
    assert port.distance(a, b) == ref.distance(a, b)
    assert port.distance_in_mm(a, b) == ref.distance_in_mm(a, b)
    np.testing.assert_array_equal(port.enlarge([0.0, 0.6, 0.8], 7.0),
                                  ref.enlarge([0.0, 0.6, 0.8], 7.0))
    np.testing.assert_array_equal(port.materials, ref.materials)
    assert port.n_triangles == ref.n_triangles == 2220
    with pytest.raises(ValueError, match="unit"):
        port.enlarge([2.0, 0.0, 0.0], 1.0)


def test_scene_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Scene(SPHERE_SCENE, small_test_config())
