"""The plain versions of K5 (listed), K6 (culled) and K7 (staged) against
the reference's Pallas kernels in interpret mode, and against the port's
brute closest hit.

``intersect_closest_{listed,culled,staged}(..., interpret=True)`` runs the
reference TPU kernels on the CPU, as ``tests/test_pallas_intersect.py``
does. Hit/miss must be equal. t is formula-identical up to XLA's FMA
contraction: rtol 1e-5, atol 1e-7 (the note of test_torch_intersect.py).
Where the winning t is unique the winner must be the same triangle (equal
mesh id and oriented normal); on an exact tie the cluster kernels keep the
first cluster they visit, so only hit and t are compared there.

Inside the port, every cluster path must give the brute plain version's
hit and t bitwise: skips and early stops drop only clusters that could at
best tie, and a strict ``<`` never takes a tie. That holds for the group of
rays a block of the kernels takes as well as for the reference's packet:
K5's plain version at every group size, K6's and K7's at their kernels'
group and at packets of 75, 100 and 2,048 rays. The CUDA kernels
themselves are held against these plain versions on the card
(chip_smoke.py, tests/test_torch_cuda.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import SPHERE_SCENE, random_segments, random_triangles, to_np, to_torch
from mcray_tpu.ops.bvh import build_bvh as ref_build_bvh
from mcray_tpu.ops.pallas import intersect as ref
from mcray_tpu_torch.config import small_test_config
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.ops import clusters, geometry
from mcray_tpu_torch.ops.cuda import (intersect_culled, intersect_listed, intersect_staged,
                                      launch_counts)
from mcray_tpu_torch.scene.compile import load_and_compile

TILE_R = 128
MODES = {
    "listed": (intersect_listed.intersect_closest_listed, ref.intersect_closest_listed, {}),
    "listed-2pass": (intersect_listed.intersect_closest_listed, ref.intersect_closest_listed,
                     {"passes": 2, "front_k": 2}),
    "culled": (intersect_culled.intersect_closest_culled, ref.intersect_closest_culled, {}),
    "staged": (intersect_staged.intersect_closest_staged, ref.intersect_closest_staged, {}),
}


@functools.lru_cache(maxsize=None)
def _case(case):
    """(tris, mesh ids, probe position, origins, segments) as numpy."""
    if case == "sphere":
        pack = load_and_compile(SPHERE_SCENE)
        cfg = small_test_config(transducer_elements=32, samples_per_element=2)
        sim = Simulator(pack, cfg, device="cpu", use_culled_intersect=False)
        rays = sim.render_frame(4)["segments"]["rays"]
        q = to_np(torch.cat([rays[0], rays[1]], dim=1)).T  # bounces 0 and 1: 128 rays
        return pack.tris, pack.tri_mesh_id, pack.transducer_position, q[:, :3], q[:, 3:]
    tris, mid = random_triangles(np.random.default_rng(5), 900)
    o, s = random_segments(np.random.default_rng(6), 150)  # 150 rays: a ragged last packet
    if case == "dead":
        o[:], s[:] = 1e9, 0.0
    else:
        o[::11], s[::11] = 1e9, 0.0  # parked dead rays among live ones
    return tris, mid, np.array([0.0, -9.0, 0.0], np.float32), o, s


def _packs(tris, mid, probe, mode):
    tile_t = 128 if mode.startswith("listed") else 256
    order = ref_build_bvh(tris).tri_order
    want = ref.pack_tris_culled(tris, mid, order, sort_origin=probe, tile_t=tile_t)
    got = clusters.pack_tris_culled(tris, mid, order, sort_origin=probe, tile_t=tile_t)
    return want, got


def _unique_winner(tris, o, s, t_best, hit):
    """Rays whose best t no other triangle comes within 1e-5 (relative) of."""
    tri_soa = geometry.triangle_soa(to_torch(tris))
    t_all, ok = geometry._moller_trumbore(to_torch(o)[:, None], to_torch(s)[:, None], *(
        tri_soa[i : i + 3].T[None] for i in (0, 3, 6)))
    t_all = to_np(torch.where(ok, t_all, 2.0))
    near = np.abs(t_all - t_best[:, None]) <= 1e-5 * t_best[:, None]
    return hit & (near.sum(axis=1) == 1)


@pytest.mark.parametrize("case", ["sphere", "random", "dead"])
@pytest.mark.parametrize("mode", list(MODES))
def test_cluster_plain_matches_pallas(mode, case):
    tris, mid, probe, o, s = _case(case)
    port_fn, ref_fn, kw = MODES[mode]
    want_pack, pack = _packs(tris, mid, probe, mode)
    want = {k: np.asarray(v) for k, v in ref_fn(
        jnp.asarray(o), jnp.asarray(s), want_pack, interpret=True, tile_r=TILE_R, **kw).items()}
    got = {k: to_np(v) for k, v in port_fn(to_torch(o), to_torch(s), pack, tile_r=TILE_R,
                                           **kw).items()}
    np.testing.assert_array_equal(got["hit"], want["hit"])
    np.testing.assert_allclose(got["t"], want["t"], rtol=1e-5, atol=1e-7)
    if case == "dead":
        assert not got["hit"].any() and (got["mesh_id"] == -1).all()
        return
    assert got["hit"].sum() > 20
    unique = _unique_winner(tris, o, s, got["t"], got["hit"])
    assert unique.sum() > 20
    np.testing.assert_array_equal(got["mesh_id"][unique], want["mesh_id"][unique])
    np.testing.assert_allclose(got["normal"][unique], want["normal"][unique], atol=1e-5)


@pytest.mark.parametrize("case", ["sphere", "random"])
@pytest.mark.parametrize("mode", list(MODES) + ["listed-frustum", "listed-hier", "listed-sorted"])
def test_cluster_plain_matches_port_brute(mode, case):
    tris, mid, probe, o, s = _case(case)
    _, pack = _packs(tris, mid, probe, mode)
    if mode in ("listed-frustum", "listed-hier"):
        port_fn, kw = intersect_listed.intersect_closest_listed, {"list_method": mode[7:]}
    else:
        port_fn, _, kw = MODES[mode.replace("-sorted", "")]
    fn = functools.partial(port_fn, tile_r=TILE_R, **kw)
    o_t, s_t = to_torch(o), to_torch(s)
    if mode == "listed-sorted":
        got = clusters.intersect_sorted(fn, o_t, s_t, pack)
    else:
        got = fn(o_t, s_t, pack)
    best_t, _ = geometry.closest_hit(o_t, s_t, geometry.triangle_soa(to_torch(tris)))
    assert int(got["hit"].sum()) > 20
    assert torch.equal(got["hit"], best_t < 1.5)
    assert torch.equal(got["t"], best_t)


def test_wrappers_run_plain_on_cpu_without_counting():
    tris, mid, probe, o, s = _case("random")
    _, pack = _packs(tris, mid, probe, "listed")
    _, _, rays = clusters.pad_rays(to_torch(o), to_torch(s), TILE_R)
    before = launch_counts()["intersect_listed"]
    lists = clusters.packet_cluster_lists(rays[0:3].T, rays[3:6].T, pack, TILE_R)
    t0 = torch.full((rays.shape[1],), geometry.NO_HIT_T)
    i0 = torch.zeros(rays.shape[1], dtype=torch.int32)
    got = intersect_listed.listed_best(rays, *lists, t0, i0, pack)
    want = intersect_listed.listed_best_plain(rays, *lists, t0, i0, pack)
    assert launch_counts()["intersect_listed"] == before
    assert got[1].dtype == torch.int32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# --- the kernel's sub-packet walk: `group` rays share a stop and a box test ---

GROUPS = [intersect_listed.GROUP, 32, 128, None]


def _listed_inputs(case, pack):
    """Padded rays (6, n_tot) and the padded origins and segments of a case."""
    _, _, _, o, s = _case(case)
    return clusters.pad_rays(to_torch(o), to_torch(s), TILE_R)


def _listed_plain(case, pack, group, passes):
    """(best_t, best_slot, live) by ``listed_best_plain`` at ``group``, in
    one pass or in the wrapper's two (front_k = 2)."""
    o, s, rays = _listed_inputs(case, pack)
    live = torch.abs(s).sum(dim=1) > 0.0
    t0 = torch.where(live, geometry.NO_HIT_T, 0.0)
    i0 = torch.zeros_like(t0, dtype=torch.int32)
    counts, ids, keys = clusters.packet_cluster_lists(o, s, pack, TILE_R)
    if passes == 1:
        return (*intersect_listed.listed_best_plain(rays, counts, ids, keys, t0, i0, pack,
                                                    group=group), live)
    c1 = torch.clamp(counts, max=2)
    bt1, bs1 = intersect_listed.listed_best_plain(rays, c1, ids, keys, t0, i0, pack, group=group)
    slots = torch.arange(ids.shape[1])[None, :] < c1[:, None]
    visited = torch.zeros_like(slots).scatter_(1, ids.long(), slots)
    lists2 = clusters.packet_cluster_lists(o, s, pack, TILE_R, t_cap=bt1, exclude=visited)
    return (*intersect_listed.listed_best_plain(rays, *lists2, bt1, bs1, pack, group=group), live)


@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("case", ["sphere", "random", "dead"])
@pytest.mark.parametrize("group", GROUPS, ids=lambda g: f"group-{g}")
def test_listed_plain_is_exact_at_every_group_size(group, case, passes):
    """A block of the kernel takes ``group`` rays of a packet, with their own
    stop and box test: the winning (t, slot) is the whole packet's bitwise,
    and still the reference's Pallas kernel's (hit equal, t to FMA rounding)."""
    tris, mid, probe, o, s = _case(case)
    want_pack, pack = _packs(tris, mid, probe, "listed")
    t_g, i_g, live = _listed_plain(case, pack, group, passes)
    t_p, i_p, _ = _listed_plain(case, pack, None, passes)
    assert torch.equal(t_g, t_p) and torch.equal(i_g, i_p)
    kw = {"passes": 2, "front_k": 2} if passes == 2 else {}
    want = {k: np.asarray(v) for k, v in ref.intersect_closest_listed(
        jnp.asarray(o), jnp.asarray(s), want_pack, interpret=True, tile_r=TILE_R, **kw).items()}
    n = o.shape[0]
    hit = to_np(live[:n] & (t_g[:n] < 1.5))
    np.testing.assert_array_equal(hit, want["hit"])
    np.testing.assert_allclose(to_np(t_g[:n])[hit], want["t"][hit], rtol=1e-5, atol=1e-7)
    assert hit.sum() > 20 or case == "dead"


@pytest.mark.parametrize("group", GROUPS, ids=lambda g: f"group-{g}")
def test_equal_t_in_two_clusters_keeps_the_first_visited(group):
    """One triangle packed into two clusters: both give the same t, and the
    strict ``<`` keeps the cluster the list visits first, whatever the group."""
    rng = np.random.default_rng(11)
    tris, mid = random_triangles(rng, 256)
    tris = tris * 0.2 + np.array([3.0, 3.0, 3.0], np.float32)   # out of the rays' way
    wall = np.array([[-2.0, 1.0, -2.0], [2.0, 1.0, -2.0], [0.0, 1.0, 3.0]], np.float32)
    tris[5] = tris[128 + 9] = wall
    pack = clusters.pack_tris_culled(tris, mid, tile_t=128)
    o = np.zeros((128, 3), np.float32)
    o[:, 0] = np.linspace(-0.5, 0.5, 128)
    s = np.tile(np.array([0.0, 2.0, 0.0], np.float32), (128, 1))
    s[::9] = 0.0                                                 # a few inert lanes
    o_t, s_t, rays = clusters.pad_rays(to_torch(o), to_torch(s), TILE_R)
    live = torch.abs(s_t).sum(dim=1) > 0.0
    counts, ids, keys = clusters.packet_cluster_lists(o_t, s_t, pack, TILE_R)
    assert int(counts[0]) == 2
    t, slot = intersect_listed.listed_best_plain(
        rays, counts, ids, keys, torch.where(live, geometry.NO_HIT_T, 0.0),
        torch.zeros(128, dtype=torch.int32), pack, group=group)
    first = int(ids[0, 0])
    want_slot = first * 128 + (5 if first == 0 else 9)
    assert torch.equal(t[live], torch.full_like(t[live], 0.5))
    assert torch.equal(slot[live], torch.full_like(slot[live], want_slot))
    assert float(t[~live].max()) == 0.0


# --- K6 and K7: a block of the kernel takes GROUP rays, not the packet ---

@functools.lru_cache(maxsize=None)
def _bounce_rays():
    """384 sphere rays (bounces 0-2 of a 64-element frame, the later ones
    with parked dead paths) as (tris, mesh ids, probe, origins, segments)."""
    pack = load_and_compile(SPHERE_SCENE)
    cfg = small_test_config(transducer_elements=64, samples_per_element=2)
    rays = Simulator(pack, cfg, device="cpu", use_culled_intersect=False).render_frame(4)[
        "segments"]["rays"]
    q = to_np(torch.cat([rays[0], rays[1], rays[2]], dim=1)).T
    return pack.tris, pack.tri_mesh_id, pack.transducer_position, q[:, :3], q[:, 3:]


@pytest.mark.parametrize("case", ["sphere", "random"])
def test_culled_kernel_inputs_equal_the_soa(case):
    """K6 reads a cluster's box from ``aabb_cluster`` and its triangles from
    the cluster-major ``hbm_tris``, where the reference reads the SoA: the
    same floats bit for bit, and the padding clusters' boxes FAR in both
    arrays."""
    tris, mid, probe, _, _ = _case(case)
    _, pack = _packs(tris, mid, probe, "culled")
    tt, n_real = pack.tile_t, pack.n_slots // pack.tile_t
    soa_tiles = pack.soa.reshape(clusters.SOA_ROWS, n_real, tt).transpose(0, 1)
    assert torch.equal(pack.aabb_cluster[:n_real, :6], soa_tiles[:, 9:15, 0])
    assert torch.equal(pack.hbm_tris[:n_real], soa_tiles)
    assert torch.equal(pack.hbm_tris[:, 9:15, 0], pack.aabb_cluster[:, :6])
    assert pack.n_clusters > n_real
    assert bool((pack.aabb_cluster[n_real:, :6] == clusters.FAR).all())


@pytest.mark.parametrize("tile_r", [75, 100, 2048])
@pytest.mark.parametrize("mode", ["culled", "staged"])
def test_culled_and_staged_plain_at_the_kernels_group(mode, tile_r):
    """A block of K6 / K7 takes GROUP consecutive rays and skips a box only
    when none of them reaches it: t and slot equal the whole packet's
    bitwise, a ragged last group included (tile_r 75: 450 padded rays); the
    closest hit equals the port's brute one's (hit and t bitwise) and the
    reference's Pallas kernel's at that packet size (hit bitwise, t to the
    reference's FMA rounding as above, the winner where t is unique)."""
    tris, mid, probe, o, s = _bounce_rays()
    want_pack, pack = _packs(tris, mid, probe, mode)
    mod = intersect_culled if mode == "culled" else intersect_staged
    plain = getattr(mod, f"{mode}_best_plain")
    _, _, rays = clusters.pad_rays(to_torch(o), to_torch(s), tile_r)
    t_g, i_g = plain(rays, pack, tile_r, group=mod.GROUP)
    t_p, i_p = plain(rays, pack, tile_r)
    assert torch.equal(t_g, t_p) and torch.equal(i_g, i_p)
    port_fn, ref_fn, _ = MODES[mode]
    want = {k: np.asarray(v) for k, v in ref_fn(
        jnp.asarray(o), jnp.asarray(s), want_pack, interpret=True, tile_r=tile_r).items()}
    got = port_fn(to_torch(o), to_torch(s), pack, tile_r=tile_r)
    best_t, _ = geometry.closest_hit(to_torch(o), to_torch(s), geometry.triangle_soa(to_torch(tris)))
    assert torch.equal(got["hit"], best_t < 1.5) and torch.equal(got["t"], best_t)
    got = {k: to_np(v) for k, v in got.items()}
    np.testing.assert_array_equal(got["hit"], want["hit"])
    np.testing.assert_allclose(got["t"], want["t"], rtol=1e-5, atol=1e-7)
    unique = _unique_winner(tris, o, s, got["t"], got["hit"])
    assert unique.sum() > 100
    np.testing.assert_array_equal(got["mesh_id"][unique], want["mesh_id"][unique])
    np.testing.assert_allclose(got["normal"][unique], want["normal"][unique], atol=1e-5)
