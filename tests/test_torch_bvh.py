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
- The 4-wide layout the card walks (``collapse4``, ``DeviceBVH``): every
  triangle in exactly one leaf, each child's box bitwise its flat node's
  padded box, the depth and the stack the walk can need as counted here by
  hand; its walk (``bvh4_best_plain``, K11's plain version) equal to the
  binary walk and the brute closest hit in (t, index) on the sphere, a random
  700-triangle set and the edge cases (no triangle, a single leaf, all dead,
  axis-parallel segments), and to the reference's traversal as the binary
  walk is; the wrapper's counts are the 4-wide walk's; a layout whose walk
  can need more stack than the kernel holds raises. ``DeviceBVH`` builds
  each layout at its first use (``from_flat`` the 4-wide one), and the
  reference walk's touched masks (the nodes and triangles K11's bound
  counts) agree with its counts ray by ray.
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
    # the wrapper walks the 4-wide tree: its counts are that walk's
    want = bvh.bvh4_best_plain(rays, device_bvh, counts=True)
    assert all(torch.equal(a, b) for a, b in zip((best_t, best_i, counts), want))
    # the binary walk: every ray pops the root; a test happens only in a leaf it entered
    t_b, i_b, (popped, tested) = bvh.bvh_best_plain(rays, device_bvh, counts=True)
    assert torch.equal(t_b, brute_t) and torch.equal(i_b, brute_i)
    assert bool((popped >= 1).all()) and int(tested.sum()) > 0
    assert bool((tested <= 4 * popped).all())
    # the 4-wide walk: a live ray visits the root, at most 4 leaves of 4 a node
    live = s.abs().sum(dim=1) > 0
    assert bool((counts[0][live] >= 1).all()) and bool((counts[1] <= 16 * counts[0]).all())


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


def _flat_tree_facts(flat: bvh.FlatBVH):
    """Each flat node's depth (root 1) and, for a leaf, its triangles."""
    depth = np.zeros(len(flat.meta), np.int64)
    depth[0] = 1
    for i, (first, count) in enumerate(flat.meta):
        if count < 0:
            depth[i + 1] = depth[first] = depth[i] + 1
    return depth


def _collapse_cases():
    rng_np = np.random.default_rng(11)
    tris, _ = random_triangles(rng_np, 700)
    sphere = load_and_compile(SPHERE_SCENE)
    return {"sphere": sphere.tris, "random 700": tris, "random 700 median split": tris,
            "single leaf": tris[:3], "no triangle": np.zeros((0, 3, 3), np.float32)}


@pytest.mark.parametrize("case", ["sphere", "random 700", "random 700 median split",
                                  "single leaf", "no triangle"])
def test_collapse_to_four_wide(case):
    """The 4-wide layout: every triangle in exactly one leaf, each child's box
    bitwise its flat node's padded box, the flat tree's nodes each held once,
    the depth and the stack need as counted here by a walk of the records."""
    tris = _collapse_cases()[case]
    flat = (bvh._build_bvh_py(tris, 4) if case.endswith("median split") or not len(tris)
            else bvh.build_bvh(tris))
    tri_soa = geometry.triangle_soa(to_torch(tris)) if len(tris) else torch.zeros((9, 0))
    dev = bvh.DeviceBVH.from_flat(flat, tri_soa)
    tree = bvh.collapse4(flat)
    records = dev.nodes4.numpy()
    assert records.shape == (tree.slots.shape[0], bvh.WIDTH, bvh.CHILD_WORDS)
    assert dev.nodes4.element_size() * bvh.WIDTH * bvh.CHILD_WORDS == 128
    padded = dev.nodes.numpy()
    held = tree.slots[tree.slots >= 0]
    assert len(set(held.tolist())) == held.size  # no flat node twice
    # each child's box bitwise its flat node's padded box; refs and counts
    for m, c in zip(*np.nonzero(tree.slots >= 0)):
        f = tree.slots[m, c]
        np.testing.assert_array_equal(records[m, c, 0:6].view(np.float32), padded[f])
        first, count = flat.meta[f]
        if count >= 0:
            assert (records[m, c, 6], records[m, c, 7]) == (first, count)
        else:
            assert records[m, c, 7] == -1 and records[m, c, 6] == tree.children[m, c]
            # an inner child's node holds its flat node's descendants
            below = tree.slots[tree.children[m, c]]
            assert (below[below >= 0] > f).all()
    assert not records[tree.slots < 0].any()  # empty slots are zero (count 0)
    # every triangle in exactly one leaf; every leaf's triangles in BVH order
    leaves = records[..., 7] > 0
    tri_pos = np.concatenate([np.arange(a, a + b) for a, b in
                              zip(records[..., 6][leaves], records[..., 7][leaves])] or [[]])
    np.testing.assert_array_equal(np.sort(tri_pos), np.arange(len(tris)))
    np.testing.assert_array_equal(dev.tris4[:, 3].contiguous().view(torch.int32).numpy(),
                                  flat.tri_order)
    np.testing.assert_array_equal(dev.tris4[:, 0:3].numpy(), dev.tri_soa[0:3].T.numpy())
    # depth and stack need, by a walk of the records from the root
    def walk(m: int) -> tuple[int, int]:
        kids = [int(records[m, c, 6]) for c in range(bvh.WIDTH) if records[m, c, 7] < 0]
        below = [walk(k) for k in kids]
        return (1 + max([d for d, _ in below], default=0),
                len(kids) - 1 + max(n for _, n in below) if kids else 0)
    assert (dev.depth, dev.stack_need) == walk(0) == (tree.depth, tree.stack_need)
    flat_depth = int(_flat_tree_facts(flat).max())
    assert dev.depth <= max(1, flat_depth - 1)
    if case == "sphere":  # the binary tree's 11 levels in 7
        assert (flat_depth, dev.depth) == (11, 7)


def _axis_rays(rng_np, tris, n: int):
    """Segments along x, y or z (two components exactly 0) through triangle centroids."""
    centroid = tris.mean(axis=1)[rng_np.integers(0, len(tris), n)]
    axis = rng_np.integers(0, 3, n)
    o = centroid.copy()
    o[np.arange(n), axis] -= 4.0
    s = np.zeros((n, 3), np.float32)
    s[np.arange(n), axis] = 8.0
    return o.astype(np.float32), s


def _walk_cases():
    rng_np = np.random.default_rng(17)
    tris, _ = random_triangles(rng_np, 700)
    o, s = random_segments(rng_np, 400)
    dead_o, dead_s = np.full((50, 3), 1e9, np.float32), np.zeros((50, 3), np.float32)
    axis_o, axis_s = _axis_rays(rng_np, tris, 300)
    sphere_tris, _, sphere_o, sphere_s = _cases()["sphere"]
    few, _ = random_triangles(rng_np, 3)
    few_o, _ = random_segments(rng_np, 200)
    few_s = (few.mean(axis=1)[rng_np.integers(0, 3, 200)] - few_o) * 1.25  # aimed at the three
    return {
        "sphere": (sphere_tris, sphere_o.numpy(), sphere_s.numpy()),
        "random 700": (tris, np.concatenate([o, dead_o]), np.concatenate([s, dead_s])),
        "axis-parallel": (tris, axis_o, axis_s),
        "all dead": (tris, dead_o, dead_s),
        "single leaf": (few, few_o, few_s),
        "no triangle": (np.zeros((0, 3, 3), np.float32), o, s),
    }


@pytest.mark.parametrize("case", ["sphere", "random 700", "axis-parallel", "all dead",
                                  "single leaf", "no triangle"])
def test_four_wide_walk_equals_the_binary_walk(case):
    """``bvh4_best_plain`` against ``bvh_best_plain`` and the brute closest
    hit: t and triangle index bitwise, whatever the 4-wide walk pruned."""
    tris, o, s = _walk_cases()[case]
    tri_soa = geometry.triangle_soa(to_torch(tris)) if len(tris) else torch.zeros((9, 0))
    flat = bvh.build_bvh(tris) if len(tris) else bvh._build_bvh_py(tris, 4)
    dev = bvh.DeviceBVH.from_flat(flat, tri_soa)
    rays = to_torch(np.concatenate([o, s], axis=1)).T.contiguous()
    t4, i4, (visited, tested) = bvh.bvh4_best_plain(rays, dev, counts=True)
    t2, i2, (popped, tested2) = bvh.bvh_best_plain(rays, dev, counts=True)
    assert torch.equal(t4.view(torch.int32), t2.view(torch.int32)) and torch.equal(i4, i2)
    if len(tris):
        brute_t, brute_i = intersect.intersect_best_plain(rays, tri_soa)
        assert torch.equal(t4, brute_t) and torch.equal(i4, brute_i)
    dead = ~(to_torch(s).abs().sum(dim=1) > 0)
    assert not bool(visited[dead].any()) and not bool(tested[dead].any())
    if case in ("all dead", "no triangle"):
        assert bool((t4 == geometry.NO_HIT_T).all()) and not bool(i4.any())
        assert not bool(visited.any())
    else:
        assert int((t4 < 1.5).sum()) > 20
        # four children a node, nearest first: fewer nodes than the binary walk pops
        assert int(visited.sum()) < int(popped.sum()) or len(flat.meta) == 1
        assert int(tested.sum()) > 0 and int(tested2.sum()) > 0


@pytest.mark.parametrize("case", ["sphere", "random 700", "single leaf", "no triangle"])
def test_reference_walk_touched_masks(case):
    """``bvh_best_plain``'s touched masks (the distinct nodes and triangles
    the bound counts): a ray alone pops each node at most once and tests
    each triangle at most once, so its masks count what its counts do; the
    masks of all rays are the union of the rays' own; (t, index) and the
    counts are those of the walk without masks."""
    tris, o, s = _walk_cases()[case]
    tri_soa = geometry.triangle_soa(to_torch(tris)) if len(tris) else torch.zeros((9, 0))
    flat = bvh.build_bvh(tris) if len(tris) else bvh._build_bvh_py(tris, 4)
    dev = bvh.DeviceBVH.from_flat(flat, tri_soa)
    rays = to_torch(np.concatenate([o, s], axis=1)).T.contiguous()
    t, i, counts, (nodes, seen) = bvh.bvh_best_plain(rays, dev, counts=True, touched=True)
    t0, i0, counts0 = bvh.bvh_best_plain(rays, dev, counts=True)
    assert torch.equal(t, t0) and torch.equal(i, i0) and torch.equal(counts, counts0)
    assert nodes.shape == (len(flat.meta),) and seen.shape == (len(tris),)
    union_nodes, union_seen = torch.zeros_like(nodes), torch.zeros_like(seen)
    for r in range(0, rays.shape[1], 7):
        _, _, (popped, tested), (n_r, s_r) = bvh.bvh_best_plain(rays[:, r:r + 1], dev,
                                                                counts=True, touched=True)
        assert (int(n_r.sum()), int(s_r.sum())) == (int(popped), int(tested))
        union_nodes |= n_r
        union_seen |= s_r
    every = torch.arange(0, rays.shape[1], 7)
    _, _, _, (n_some, s_some) = bvh.bvh_best_plain(rays[:, every], dev, counts=True,
                                                   touched=True)
    assert torch.equal(n_some, union_nodes) and torch.equal(s_some, union_seen)
    if len(tris):
        assert bool(nodes[0]) and int(seen.sum()) > 0
        assert int(nodes.sum()) <= int(counts[0].sum())
        assert int(seen.sum()) <= int(counts[1].sum())
    else:
        assert not bool(nodes.any())


def test_device_bvh_builds_each_layout_at_first_use(monkeypatch):
    """``DeviceBVH.from_flat`` builds the 4-wide layout the card walks, not
    the binary tree; the binary tree's arrays are built when the reference
    walk first reads them, and the reference's arguments
    (``bvh_intersect_closest``) build no 4-wide layout."""
    tris, o, s = _walk_cases()["random 700"]
    tri_soa = geometry.triangle_soa(to_torch(tris))
    flat = bvh.build_bvh(tris)
    dev = bvh.DeviceBVH.from_flat(flat, tri_soa)
    layouts = ("nodes", "meta", "tri_order", "tri_soa", "tree4", "nodes4", "tris4")
    built = lambda b: {k for k in layouts if k in vars(b)}  # noqa: E731
    assert built(dev) == {"tree4", "nodes4", "tris4"}
    rays = to_torch(np.concatenate([o, s], axis=1)).T.contiguous()
    t4, i4 = bvh.bvh4_best_plain(rays, dev)
    assert built(dev) == {"tree4", "nodes4", "tris4"}
    t2, i2 = bvh.bvh_best_plain(rays, dev)
    assert built(dev) == {"nodes", "meta", "tri_order", "tri_soa", "tree4", "nodes4", "tris4"}
    assert torch.equal(t4, t2) and torch.equal(i4, i2)
    np.testing.assert_array_equal(dev.tri_soa.numpy(), tri_soa[:, flat.tri_order].numpy())
    lazy = bvh.DeviceBVH(flat, tri_soa)
    assert built(lazy) == set()
    bvh.bvh_best_plain(rays, lazy)
    assert built(lazy) == {"nodes", "meta", "tri_order", "tri_soa"}

    def no_collapse(flat):
        raise AssertionError("collapse4 called")

    monkeypatch.setattr(bvh, "collapse4", no_collapse)
    hits = bvh.bvh_intersect_closest(rays[:3].T, rays[3:].T, to_torch(tris),
                                     torch.zeros(len(tris), dtype=torch.int32), flat.nodes,
                                     flat.meta, flat.tri_order)
    assert torch.equal(hits["hit"], t2 < 1.5)


@pytest.mark.parametrize("case", ["random", "sphere"])
def test_four_wide_walk_matches_reference(case):
    """The 4-wide walk's winners through the plain tail, against the
    reference's traversal (``mcray_tpu.ops.bvh.bvh_intersect_closest``), as
    ``test_plain_traversal_matches_reference`` holds the binary walk."""
    tris, mid, o, s = _cases()[case]
    flat = bvh.build_bvh(tris)
    want = {k: np.asarray(v) for k, v in ref_bvh_intersect_closest(
        jnp.asarray(to_np(o)), jnp.asarray(to_np(s)), jnp.asarray(tris), jnp.asarray(mid),
        jnp.asarray(flat.nodes), jnp.asarray(flat.meta), jnp.asarray(flat.tri_order)).items()}
    tri_soa = geometry.triangle_soa(to_torch(tris))
    rays = torch.cat([o, s], dim=1).T.contiguous()
    best_t, best_i = bvh.bvh4_best_plain(rays, bvh.DeviceBVH.from_flat(flat, tri_soa))
    got = {k: to_np(v) for k, v in geometry.winner_hits(o, s, tri_soa, to_torch(mid), best_t,
                                                         best_i).items()}
    assert want["hit"].sum() > 20
    np.testing.assert_array_equal(got["hit"], want["hit"])
    np.testing.assert_allclose(got["t"], want["t"], rtol=1e-5, atol=1e-7)
    unique = _unique(o, s, tri_soa, got["t"])
    assert unique.sum() > 20
    np.testing.assert_array_equal(got["mesh_id"][unique], want["mesh_id"][unique])
    np.testing.assert_allclose(got["normal"][unique], want["normal"][unique], atol=1e-5)


def _caterpillar(levels: int):
    """A hand-built deep binary tree over 2 x ``levels`` + 1 triangles on the x
    axis: each level's inner node holds a small inner node (two one-triangle
    leaves) on the left and the next level on the right; every 4-wide node
    then holds three small inner nodes and the next level, and its walk can
    push three entries a level."""
    tris = np.zeros((2 * levels + 1, 3, 3), np.float32)
    tris[:, :, 0] = np.arange(2 * levels + 1, dtype=np.float32)[:, None] + [0.0, 0.5, 0.0]
    tris[:, 2, 1] = 0.5
    nodes, meta, order = [], [], []

    def box(idx):
        pts = tris[idx].reshape(-1, 3)
        return [*pts.min(axis=0), *pts.max(axis=0)]

    def leaf(k):
        nodes.append(box([k]))
        meta.append([len(order), 1])
        order.append(k)

    for level in range(levels):
        nodes.append(box(list(range(2 * level, 2 * levels + 1))))
        meta.append([0, -1])
        me = len(nodes) - 1
        nodes.append(box([2 * level, 2 * level + 1]))
        meta.append([len(nodes) + 1, -1])
        leaf(2 * level)
        leaf(2 * level + 1)
        meta[me][0] = len(nodes)
    leaf(2 * levels)
    return tris, bvh.FlatBVH(np.asarray(nodes, np.float32), np.asarray(meta, np.int32),
                             np.asarray(order, np.int32))


def test_stack_guard_refuses_a_deep_tree():
    """A layout whose 4-wide walk can need more stack than the kernel holds
    (``STACK4``) raises a ``ValueError`` in the wrapper and the plain walk,
    where the binary walk would clamp its stack and lose nodes; one level
    less fits."""
    levels_fit = bvh.STACK4 // 3 * 3  # three levels a 4-wide node, three entries each
    tris, flat = _caterpillar(levels_fit)
    dev = bvh.DeviceBVH.from_flat(flat, geometry.triangle_soa(to_torch(tris)))
    assert dev.stack_need <= bvh.STACK4
    rays = to_torch([[0.25, 0.1, -1.0, 0.0, 0.0, 2.0]], torch.float32).T.contiguous()
    t, i = bvh_intersect.bvh_best(rays, dev)
    assert float(t) == 0.5 and int(i) == 0
    tris, flat = _caterpillar(levels_fit + 6)
    dev = bvh.DeviceBVH.from_flat(flat, geometry.triangle_soa(to_torch(tris)))
    assert dev.stack_need > bvh.STACK4
    with pytest.raises(ValueError, match="stack"):
        bvh_intersect.bvh_best(rays, dev)
    with pytest.raises(ValueError, match="stack"):
        bvh.bvh4_best_plain(rays, dev)
