"""The port's cluster packing, BVH order and listed prepass against mcray_tpu's.

``ops/clusters.py:pack_tris_culled`` must equal the reference's
``pack_tris_culled`` array for array (the same numpy arithmetic on the same
BVH order), and ``packet_cluster_lists`` its ``_packet_cluster_lists``:
counts and sorted keys bitwise (the same slab formulas, each op rounded
once on both sides), and the same survivor set per packet. Both stable
sorts carry the cluster ids, so the lists come out in the same order too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import SPHERE_SCENE, random_segments, random_triangles, to_np, to_torch
from mcray_tpu.ops.bvh import build_bvh as ref_build_bvh
from mcray_tpu.ops.pallas import intersect as ref
from mcray_tpu_torch.ops import bvh, clusters
from mcray_tpu_torch.scene.compile import load_and_compile
from mcray_tpu_torch.utils.convert import culled_from_reference

FIELDS = ("soa", "slot_all", "hbm_tris", "aabb_cluster", "aabb_super", "scene_lo", "scene_hi")
SLOT_COLUMNS = {"slot_v0": (0, 3), "slot_e1": (3, 6), "slot_e2": (6, 9), "slot_mesh_id": (9, 10)}
STATICS = ("n_slots", "n_clusters", "n_super", "tile_t", "super_g")


def _scene(case):
    if case == "sphere":
        pack = load_and_compile(SPHERE_SCENE)
        return pack.tris, pack.tri_mesh_id, pack.transducer_position
    # 700 triangles: a ragged last cluster at tile_t 128 (60) and 256 (188)
    tris, mid = random_triangles(np.random.default_rng(2), 700)
    return tris, mid, np.array([0.0, -9.0, 0.0], np.float32)


@pytest.mark.parametrize("tile_t", [128, 256])
@pytest.mark.parametrize("case", ["sphere", "random"])
def test_pack_tris_culled_matches_reference(case, tile_t):
    tris, mid, probe = _scene(case)
    want_bvh, got_bvh = ref_build_bvh(tris), bvh.build_bvh(tris)
    for f in ("nodes", "meta", "tri_order"):
        np.testing.assert_array_equal(getattr(got_bvh, f), getattr(want_bvh, f), err_msg=f)
    want = ref.pack_tris_culled(tris, mid, want_bvh.tri_order, sort_origin=probe, tile_t=tile_t)
    got = clusters.pack_tris_culled(tris, mid, got_bvh.tri_order, sort_origin=probe,
                                    tile_t=tile_t)
    for f in FIELDS:
        np.testing.assert_array_equal(to_np(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)
    # the reference's per-field slot tables are the columns of slot_all
    for f, (a, b) in SLOT_COLUMNS.items():
        want_f = np.asarray(getattr(want, f))
        np.testing.assert_array_equal(to_np(got.slot_all[:, a:b]).reshape(want_f.shape), want_f,
                                      err_msg=f)
    for f in STATICS:
        assert getattr(got, f) == getattr(want, f), f
    # and the reference's tables carried across unchanged
    carried = culled_from_reference(want, device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(carried, f), getattr(got, f)), f


def _rays(rng, n=384, dead_every=17):
    o, s = random_segments(rng, n)
    o[::dead_every], s[::dead_every] = 1e9, 0.0  # parked dead rays, as the bounce loop parks them
    return o, s


def _packs(super_g=None):
    tris, mid = random_triangles(np.random.default_rng(3), 900)
    order = ref_build_bvh(tris).tri_order
    want = ref.pack_tris_culled(tris, mid, order, tile_t=128, super_g=super_g)
    return want, clusters.pack_tris_culled(tris, mid, order, tile_t=128, super_g=super_g)


def _assert_lists_equal(got, want):
    counts, ids, keys = (to_np(x) for x in got)
    w_counts, w_ids, w_keys = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(counts, w_counts[:, 0])
    np.testing.assert_array_equal(keys, w_keys)
    for p in range(counts.shape[0]):
        assert set(ids[p, : counts[p]]) == set(w_ids[p, : counts[p]]), f"packet {p}"
    assert counts.sum() > 0


@pytest.mark.parametrize("method", ["exact", "exact-capped", "frustum", "hier"])
def test_packet_cluster_lists_match_reference(rng, method):
    want_pack, pack = _packs(super_g=2 if method == "hier" else None)
    o, s = _rays(rng)
    kw = {}
    if method == "exact-capped":
        p, c = o.shape[0] // 128, pack.n_clusters
        kw = {"t_cap": rng.uniform(0.0, 1.2, o.shape[0]).astype(np.float32),
              "exclude": rng.uniform(size=(p, c)) < 0.3}
    m = method.split("-")[0]
    want = ref._packet_cluster_lists(jnp.asarray(o), jnp.asarray(s), want_pack, tile_r=128,
                                     method=m, **{k: jnp.asarray(v) for k, v in kw.items()})
    got = clusters.packet_cluster_lists(to_torch(o), to_torch(s), pack, 128, method=m,
                                        **{k: to_torch(v) for k, v in kw.items()})
    _assert_lists_equal(got, want)


def test_packet_sort_keys_match_reference(rng):
    want_pack, pack = _packs()
    o, s = _rays(rng)
    want = np.asarray(ref.packet_sort_keys(jnp.asarray(o), jnp.asarray(s), want_pack))
    np.testing.assert_array_equal(to_np(clusters.packet_sort_keys(to_torch(o), to_torch(s), pack)),
                                  want)
