"""The plain version of K10 (grouped, cluster-major closest hit) against the
reference's Pallas kernel in interpret mode, against the port's listed and
brute closest hits, and the invariants of its ray tables.

The cases are those of the reference's own test
(``tests/test_pallas_intersect.py::test_grouped_intersect_matches_jnp``):
900 random triangles in 128-triangle clusters; 300 isotropic rays of which
about a fifth are parked dead (far origin, zero segment); and a 300-ray fan
from one apex, which overflows every per-chunk and per-cluster ray budget
and so runs through the residual listed pass. Three budget settings.

Against the reference hit/miss must be equal. t is not compared bitwise:
the reference's kernel is one jitted XLA program even in interpret mode,
and XLA's CPU code contracts Möller–Trumbore's multiply-adds into FMAs,
while the port rounds every op (as its CUDA kernels do, built without
contraction); so t compares at rtol 1e-5, atol 1e-7, the reference's own
tolerance against its jnp brute force. Where the winning t is unique the
winner must be the same triangle (equal mesh id).

Inside the port, grouped = listed = brute bitwise in hit and t: all three
evaluate one formula op by op, and the pruning drops only clusters that
could at best tie.

K10 on the card reduces per ray in the kernel: each slot's triangles cut
into parts (and a cluster's triangles into ranges over warps), each part
walked in ascending order with a strict ``<``, the parts merged on (t, slot)
by the warp's xor butterfly, the ranges and the slots by a 64-bit integer
minimum per ray. That rule is held here, in plain torch, to the per-(cluster,
slot) tables of ``grouped_best_plain`` and to ``grouped_winners_plain``
bitwise.
"""

import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import random_triangles, to_np, to_torch
from mcray_tpu.ops.bvh import build_bvh as ref_build_bvh
from mcray_tpu.ops.pallas import intersect as ref
from mcray_tpu_torch.ops import clusters, geometry
from mcray_tpu_torch.ops.cuda import intersect_grouped, intersect_listed, launch_counts
from test_torch_intersect_clusters import _unique_winner

N_RAYS = 300
BUDGETS = {  # name: (port keywords, extra reference keywords)
    "g32-c4": ({"group_g": 32, "chunk_g": 4}, {}),
    "g8-c1": ({"group_g": 8, "chunk_g": 1}, {}),
    # batch_b above the cluster count forces the reference's cluster padding;
    # the port has no cluster batching to pad for
    "g16-c2": ({"group_g": 16, "chunk_g": 2}, {"batch_b": 16}),
}


@functools.lru_cache(maxsize=None)
def _scene():
    tris, mid = random_triangles(np.random.default_rng(5), 900)
    order = ref_build_bvh(tris).tri_order
    want = ref.pack_tris_culled(tris, mid, order, tile_t=128)
    got = clusters.pack_tris_culled(tris, mid, order, tile_t=128)
    return tris, mid, want, got


@functools.lru_cache(maxsize=None)
def _rays(case):
    """(origins, segments) as numpy: ``bounce`` isotropic with parked dead
    rays, ``fan`` coherent from one apex, ``sparse`` a few short rays."""
    rng = np.random.default_rng(7)
    if case == "fan":
        th = np.linspace(-0.4, 0.4, N_RAYS)
        s = np.stack([np.cos(th) * 20, np.sin(th) * 20, np.zeros(N_RAYS)], -1).astype(np.float32)
        return np.tile(np.array([[-9.0, 0.0, 0.0]], np.float32), (N_RAYS, 1)), s
    n = 40 if case == "sparse" else N_RAYS
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    s = (rng.standard_normal((n, 3)) * (4 if case == "sparse" else 9)).astype(np.float32)
    dead = rng.uniform(size=n) < 0.2
    s[dead], o[dead] = 0.0, 1e9
    return o, s


@pytest.mark.parametrize("case", ["bounce", "fan"])
@pytest.mark.parametrize("budget", list(BUDGETS))
def test_grouped_plain_matches_pallas(budget, case):
    tris, _, want_pack, pack = _scene()
    o, s = _rays(case)
    kw, ref_kw = BUDGETS[budget]
    want = {k: np.asarray(v) for k, v in ref.intersect_closest_grouped(
        jnp.asarray(o), jnp.asarray(s), want_pack, interpret=True, **kw, **ref_kw).items()}
    got = {k: to_np(v) for k, v in intersect_grouped.intersect_closest_grouped(
        to_torch(o), to_torch(s), pack, **kw).items()}
    np.testing.assert_array_equal(got["hit"], want["hit"])
    np.testing.assert_allclose(got["t"], want["t"], rtol=1e-5, atol=1e-7)
    assert got["hit"].sum() > 20
    unique = _unique_winner(tris, o, s, got["t"], got["hit"])
    assert unique.sum() > 20
    np.testing.assert_array_equal(got["mesh_id"][unique], want["mesh_id"][unique])
    dead = np.abs(s).sum(axis=1) == 0
    assert not got["hit"][dead].any() and (got["mesh_id"][dead] == -1).all()


@pytest.mark.parametrize("case", ["bounce", "fan"])
@pytest.mark.parametrize("budget", list(BUDGETS))
def test_grouped_equals_listed_and_brute_bitwise(budget, case):
    tris, _, _, pack = _scene()
    o, s = (to_torch(x) for x in _rays(case))
    got = intersect_grouped.intersect_closest_grouped(o, s, pack, **BUDGETS[budget][0])
    listed = intersect_listed.intersect_closest_listed(o, s, pack)
    best_t, _ = geometry.closest_hit(o, s, geometry.triangle_soa(to_torch(tris)))
    assert int(got["hit"].sum()) > 20
    assert torch.equal(got["hit"], best_t < 1.5) and torch.equal(got["t"], best_t)
    assert torch.equal(got["hit"], listed["hit"]) and torch.equal(got["t"], listed["t"])


def _tables(case, group_g, chunk_g):
    _, _, _, pack = _scene()
    o, s = (to_torch(x) for x in _rays(case))
    o, s, rays = clusters.pad_rays(o, s, 128, 1e9)
    hit, live = clusters.ray_cluster_hits(o, s, pack)
    return pack, (o, s, rays), (hit, live), clusters.cluster_ray_tables(hit, group_g, chunk_g)


@pytest.mark.parametrize("case", ["bounce", "fan"])
@pytest.mark.parametrize("budget", list(BUDGETS))
def test_ray_tables_hold_every_incidence_or_overflow(budget, case):
    """Every live (ray, cluster) incidence is in the cluster's table or the
    cluster is marked overflowed; no inert ray is in any table; a cluster
    keeps its rays in ray order, the first ``chunk_g`` of each chunk."""
    kw = BUDGETS[budget][0]
    pack, (_, s, _), (hit, live), (ray_ids, counts, overflow) = _tables(case, **kw)
    n_tot, n_c = hit.shape
    g = ray_ids.shape[1]
    assert g == clusters.group_width(n_tot, **kw) and g % 8 == 0 and g <= kw["group_g"]
    assert not bool(hit[~live].any()) and int((~live).sum()) > 0
    used = torch.arange(g)[None, :] < counts[:, None]
    in_table = torch.zeros((n_tot, n_c), dtype=torch.bool)
    cluster_of = torch.arange(n_c)[:, None].expand(n_c, g)
    in_table[ray_ids[used].long(), cluster_of[used]] = True
    assert bool((in_table <= hit).all())                       # only true incidences
    assert bool((in_table | overflow[None, :] | ~hit).all())   # all of them, or overflow
    assert bool(live[ray_ids[used].long()].all())              # no inert ray
    assert bool((ray_ids[~used] == 0).all())
    for c in range(n_c):
        ids = ray_ids[c, : int(counts[c])]
        assert bool((ids[1:] > ids[:-1]).all())
        want = []
        for ch in range(n_tot // 128):
            want += (torch.nonzero(hit[ch * 128 : (ch + 1) * 128, c])[:, 0] + ch * 128)[
                : kw["chunk_g"]].tolist()
        assert ids.tolist() == want[:g]
        dropped = int(hit[:, c].sum()) > len(ids)
        assert bool(overflow[c]) == dropped
    assert bool(overflow.any())  # 8 clusters for ~300 rays: some budget is always exceeded


def test_no_overflow_leaves_the_residual_pass_nothing():
    """Forty rays with a budget of 32 per chunk overflow nothing: the residual pass's lists are
    empty, and the grouped winners are already the brute closest hits."""
    tris, _, _, _ = _scene()
    pack, (o, s, rays), (_, live), (ray_ids, counts, overflow) = _tables("sparse", 32, 32)
    assert not bool(overflow.any()) and int(counts.sum()) > 10
    inc_t, inc_slot = intersect_grouped.grouped_best(rays, ray_ids, counts, pack)
    t, slot = clusters.ray_winners(ray_ids, inc_t, inc_slot, rays.shape[1])
    counts2, _, _ = clusters.packet_cluster_lists(o, s, pack, 128, t_cap=t,
                                                  exclude=~overflow[None, :])
    assert bool((counts2 == 0).all())
    best_t, best_idx = geometry.closest_hit(o, s, geometry.triangle_soa(to_torch(tris)))
    assert torch.equal(t, best_t) and int((t < 1.5).sum()) > 3
    assert bool((slot[t > 1.5] == 0).all())
    # the winning slot names the brute winner's triangle
    hit = t < 1.5
    rows = pack.slot_all[slot[hit].long()]
    soa = geometry.triangle_soa(to_torch(tris))
    assert torch.equal(rows[:, 0:9], soa[:, best_idx[hit]].T)


def test_grouped_kernel_table_contract():
    """Per used slot the minimum t of its cluster and the first triangle
    attaining it (cluster * tile_t when nothing is hit); unused slots are
    (NO_HIT_T, 0); on the CPU the wrapper runs the plain version uncounted."""
    pack, (_, _, rays), _, (ray_ids, counts, _) = _tables("bounce", 32, 4)
    before = launch_counts()["intersect_grouped"]
    t, slot = intersect_grouped.grouped_best(rays, ray_ids, counts, pack)
    assert launch_counts()["intersect_grouped"] == before
    assert t.shape == slot.shape == ray_ids.shape
    assert t.dtype == torch.float32 and slot.dtype == torch.int32
    used = torch.arange(ray_ids.shape[1])[None, :] < counts[:, None]
    assert bool((t[~used] == geometry.NO_HIT_T).all()) and bool((slot[~used] == 0).all())
    base = (torch.arange(pack.n_clusters) * pack.tile_t)[:, None].expand_as(slot)
    miss = used & (t > 1.5)
    assert int(miss.sum()) > 0 and bool((slot[miss] == base[miss]).all())
    hit = used & (t < 1.5)
    assert int(hit.sum()) > 10  # of 8 clusters x 8 slots
    assert bool(((slot[hit] >= base[hit]) & (slot[hit] < base[hit] + pack.tile_t)).all())
    # each reported t is that ray's t against the reported triangle
    o, s = rays[0:3].T[ray_ids[hit].long()], rays[3:6].T[ray_ids[hit].long()]
    rows = pack.slot_all[slot[hit].long()]
    tt, ok = geometry._moller_trumbore(o, s, rows[:, 0:3], rows[:, 3:6], rows[:, 6:9])
    assert bool(ok.all()) and torch.equal(tt, t[hit])


def test_residual_tile_must_be_a_multiple_of_the_chunk():
    _, _, _, pack = _scene()
    o, s = (to_torch(x) for x in _rays("sparse"))
    with pytest.raises(ValueError, match="residual_tile_r"):
        intersect_grouped.intersect_closest_grouped(o, s, pack, residual_tile_r=100)
    with pytest.raises(ValueError, match="multiples of 128"):
        clusters.cluster_ray_tables(torch.zeros((100, 8), dtype=torch.bool), 32, 4)


def _k10_rule(rays, ray_ids, counts, pack, splits, parts):
    """K10's decomposition in plain torch: per (cluster, slot, range, part)
    the first triangle at the least t of its share (triangles j0 + p, j0 + p
    + parts, ... of range q, ascending, strict ``<``); the parts merged by the
    warp's xor butterfly on (t, slot); returns per (cluster, slot, range) the
    merged (t, slot), (NO_HIT_T, INT_MAX) where the share has no hit (the
    kernel issues no atomic for it)."""
    n_c, g = ray_ids.shape
    tile_t = pack.tile_t
    ids = ray_ids.long()
    o = rays[0:3].T[ids][:, :, None]
    s = rays[3:6].T[ids][:, :, None]
    v0, e1, e2 = (pack.hbm_tris[:, r : r + 3].transpose(1, 2)[:, None] for r in (0, 3, 6))
    tt, valid = geometry._moller_trumbore(o, s, v0, e1, e2)     # (C, G, T)
    valid &= (torch.arange(g)[None, :] < counts[:, None])[:, :, None]
    base = (torch.arange(n_c) * tile_t)[:, None]
    bt = torch.full((n_c, g, splits, parts), geometry.NO_HIT_T)
    bi = torch.full((n_c, g, splits, parts), 2**31 - 1, dtype=torch.int64)
    for q, p in itertools.product(range(splits), range(parts)):
        for j in range(q * tile_t // splits + p, (q + 1) * tile_t // splits, parts):
            better = valid[:, :, j] & (tt[:, :, j] < bt[:, :, q, p])
            bt[:, :, q, p] = torch.where(better, tt[:, :, j], bt[:, :, q, p])
            bi[:, :, q, p] = torch.where(better, base + j, bi[:, :, q, p])
    off = 1
    while off < parts:  # lane l meets lane l ^ off; the lesser (t, slot) stays
        partner = torch.arange(parts) ^ off
        ot, oi = bt[..., partner], bi[..., partner]
        take = (ot < bt) | ((ot == bt) & (oi < bi))
        bt, bi = torch.where(take, ot, bt), torch.where(take, oi, bi)
        off *= 2
    return bt[..., 0], bi[..., 0]


@pytest.mark.parametrize("case", ["bounce", "fan"])
@pytest.mark.parametrize("budget", list(BUDGETS))
def test_lane_split_merge_matches_plain(budget, case):
    """K10's rule, each slot's 128 triangles cut into 1 to 32 parts (and the
    cluster into 1, 2, 4 or 8 ranges): merged over the ranges on (t, slot), it
    equals ``grouped_best_plain``'s table bitwise; reduced per ray by the
    integer key over the shares with a hit only, ``grouped_winners_plain``."""
    pack, (_, _, rays), _, (ray_ids, counts, _) = _tables(case, **BUDGETS[budget][0])
    want_t, want_slot = intersect_grouped.grouped_best_plain(rays, ray_ids, counts, pack)
    win_t, win_slot = intersect_grouped.grouped_winners_plain(rays, ray_ids, counts, pack)
    used = torch.arange(ray_ids.shape[1])[None, :] < counts[:, None]
    n_tot = rays.shape[1]
    for splits, parts in itertools.product((1, 2, 4, 8), (1, 2, 4, 8, 16, 32)):
        t, slot = _k10_rule(rays, ray_ids, counts, pack, splits, parts)
        key = (t.view(torch.int32).long() << 32) | slot
        merged = key.min(dim=2).values
        hit = (merged >> 32) != clusters.NO_HIT_KEY >> 32
        assert int(hit.sum()) > 0 and not bool((hit & ~used).any())
        m_t, m_slot = (merged >> 32).int().view(torch.float32), (merged & 0xFFFFFFFF).int()
        assert torch.equal(m_t[hit], want_t[hit]) and torch.equal(m_slot[hit], want_slot[hit])
        assert bool((want_t[used & ~hit] == geometry.NO_HIT_T).all())
        # the per-ray reduction: atomics only where a share has a hit
        keys = torch.full((n_tot,), clusters.NO_HIT_KEY, dtype=torch.int64)
        keys.scatter_reduce_(0, ray_ids.long()[hit], merged[hit], "amin", include_self=True)
        assert torch.equal((keys >> 32).int().view(torch.float32), win_t), (splits, parts)
        assert torch.equal((keys & 0xFFFFFFFF).int(), win_slot), (splits, parts)


@pytest.mark.parametrize("case", ["bounce", "fan"])
@pytest.mark.parametrize("budget", list(BUDGETS))
def test_grouped_winners_reduce_the_tables_per_ray(budget, case):
    """On CPU tensors ``grouped_winners`` runs ``grouped_winners_plain``,
    uncounted: ``ray_winners`` over ``grouped_best_plain``'s tables, per
    padded ray. Inert rays keep (NO_HIT_T, 0); every winner's t is its ray's
    t against the winning triangle, never below the brute closest hit, and
    equal to it where the ray's every incidence is in the tables."""
    pack, (o, s, rays), (hit_m, live), (ray_ids, counts, overflow) = _tables(
        case, **BUDGETS[budget][0])
    before = launch_counts()["intersect_grouped"]
    t, slot = intersect_grouped.grouped_winners(rays, ray_ids, counts, pack)
    assert launch_counts()["intersect_grouped"] == before
    n_tot = rays.shape[1]
    assert t.shape == slot.shape == (n_tot,) and t.dtype == torch.float32
    assert slot.dtype == torch.int32
    want = clusters.ray_winners(ray_ids, *intersect_grouped.grouped_best_plain(
        rays, ray_ids, counts, pack), n_tot)
    assert torch.equal(t, want[0]) and torch.equal(slot, want[1])
    assert bool((t[~live] == geometry.NO_HIT_T).all()) and bool((slot[~live] == 0).all())
    won = t < 1.5
    assert int(won.sum()) > 0
    rows = pack.slot_all[slot[won].long()]
    tt, ok = geometry._moller_trumbore(o[won], s[won], rows[:, 0:3], rows[:, 3:6], rows[:, 6:9])
    assert bool(ok.all()) and torch.equal(tt, t[won])
    tris = _scene()[0]
    best_t, _ = geometry.closest_hit(o, s, geometry.triangle_soa(to_torch(tris)))
    assert bool((t >= best_t).all())
    whole = ~(hit_m & overflow[None, :]).any(dim=1)   # no incidence left to the residual pass
    assert int(whole.sum()) > 0 and torch.equal(t[whole], best_t[whole])
