"""K1's plain version against the reference's Pallas brute intersect kernel.

``intersect_closest_pallas(..., interpret=True)`` runs the reference TPU
kernel on the CPU. The closest hit is discrete: hit/miss must be equal, and
where the winning t is unique the winner must be the same triangle (equal
mesh id and oriented normal). t is formula-identical up to XLA's FMA
contraction: rtol 1e-5, atol 1e-7, the reference's own kernel tolerance.
The CUDA kernel itself is held against this plain version on the card
(chip_smoke.py, tests/test_torch_cuda.py). The kernel cuts the triangle axis
into parts and merges the parts' winners on (t, index): the split plain
version that models it must equal the plain version bitwise for any number
of parts, ties and misses included.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import SPHERE_SCENE, random_segments, random_triangles, to_np, to_torch
from mcray_tpu.ops.pallas.intersect import intersect_closest_pallas
from mcray_tpu_torch.config import small_test_config
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.ops import geometry
from mcray_tpu_torch.ops.cuda import intersect, launch_counts
from mcray_tpu_torch.scene.compile import load_and_compile


def _sphere_rays():
    """The port's own bounce-0 and bounce-1 closest-hit queries on the sphere."""
    pack = load_and_compile(SPHERE_SCENE)
    cfg = small_test_config(transducer_elements=32, samples_per_element=2)
    rays = Simulator(pack, cfg, device="cpu").render_frame(4)["segments"]["rays"]
    return pack.tris, pack.tri_mesh_id, torch.cat([rays[0], rays[1]], dim=1).T


def _random_rays(rng):
    tris, mid = random_triangles(rng, 700)  # 700 % 256 != 0: a ragged tile
    o, s = random_segments(rng, 150)
    return tris, mid, to_torch(np.concatenate([o, s], axis=1))


@pytest.mark.parametrize("case", ["random", "sphere"])
def test_intersect_plain_matches_pallas(rng, case):
    tris, mid, rays = _random_rays(rng) if case == "random" else _sphere_rays()
    o, s = rays[:, :3].contiguous(), rays[:, 3:].contiguous()
    want = {k: np.asarray(v) for k, v in intersect_closest_pallas(
        jnp.asarray(to_np(o)), jnp.asarray(to_np(s)), jnp.asarray(tris), jnp.asarray(mid),
        interpret=True).items()}

    tri_soa = geometry.triangle_soa(to_torch(tris))
    best_t, best_idx = intersect.intersect_best_plain(torch.cat([o, s], dim=1).T, tri_soa)
    got = {k: to_np(v) for k, v in geometry.winner_hits(
        o, s, tri_soa, to_torch(mid), best_t, best_idx).items()}

    assert want["hit"].sum() > 20
    np.testing.assert_array_equal(got["hit"], want["hit"])
    np.testing.assert_allclose(got["t"], want["t"], rtol=1e-5, atol=1e-7)
    # unique winner: no other triangle within 1e-5 relative of the best t
    t_all, ok = geometry._moller_trumbore(o[:, None], s[:, None], *(
        tri_soa[i : i + 3].T[None] for i in (0, 3, 6)))
    t_all = to_np(torch.where(ok, t_all, 2.0))
    near = np.abs(t_all - got["t"][:, None]) <= 1e-5 * got["t"][:, None]
    unique = got["hit"] & (near.sum(axis=1) == 1)
    assert unique.sum() > 20
    np.testing.assert_array_equal(got["mesh_id"][unique], want["mesh_id"][unique])
    np.testing.assert_allclose(got["normal"][unique], want["normal"][unique], atol=1e-5)


def test_wrapper_runs_plain_on_cpu_without_counting(rng):
    tris, _, rays = _random_rays(rng)
    tri_soa = geometry.triangle_soa(to_torch(tris))
    before = launch_counts()["intersect"]
    best_t, best_idx = intersect.intersect_best(rays.T.contiguous(), tri_soa)
    want_t, want_idx = intersect.intersect_best_plain(rays.T.contiguous(), tri_soa)
    assert launch_counts()["intersect"] == before
    assert best_idx.dtype == torch.int32
    assert torch.equal(best_t, want_t) and torch.equal(best_idx, want_idx)


def _take_min(a: tuple, b: tuple) -> tuple:
    """The (t, index) lexicographic minimum of two winners, ray by ray: the
    least t, the lower index on equal t."""
    (t_a, i_a), (t_b, i_b) = a, b
    b_wins = (t_b < t_a) | ((t_b == t_a) & (i_b < i_a))
    return torch.where(b_wins, t_b, t_a), torch.where(b_wins, i_b, i_a)


def _split_best(rays, tri_soa, parts: int):
    """K1's decomposition in plain torch: the triangles cut into ``parts``
    contiguous parts as the kernel cuts them (part p starts at T * p //
    parts), each part's winner (indices offset to the whole SoA), then the
    (t, index) minimum over the parts."""
    t_count = tri_soa.shape[1]
    best = intersect.intersect_best_plain(rays, tri_soa[:, :0])
    for p in range(parts):
        lo, hi = t_count * p // parts, t_count * (p + 1) // parts
        if hi > lo:
            t, i = intersect.intersect_best_plain(rays, tri_soa[:, lo:hi])
            best = _take_min(best, (t, torch.where(t < geometry.NO_HIT_T, i + lo, 0)))
    return best


@functools.lru_cache(maxsize=None)
def _split_case(case: str):
    """(rays (6, N), tri_soa (9, T)) of one case for the split winner rule."""
    rng = np.random.default_rng(3)
    if case == "sphere":
        tris, _, rays = _sphere_rays()
        return rays.T.contiguous(), geometry.triangle_soa(to_torch(tris))
    tris, _ = random_triangles(rng, {"random": 700, "t1": 1, "t0": 0}.get(case, 300))
    o, s = random_segments(rng, 400)
    if case == "t1":  # every ray aimed through the one triangle's centroid
        o = o / 4
        s = (tris[0].mean(axis=0) - o) * 1.5
    if case == "duplicated":  # triangles 0-149 again at 300-449: equal t, the lower index wins
        tris = np.concatenate([tris, tris[:150]])
    if case == "all dead":  # parked dead paths: far away, zero segment
        o, s = np.full_like(o, 1e9), np.zeros_like(s)
    rays = to_torch(np.concatenate([o, s], axis=1)).T.contiguous()
    return rays, geometry.triangle_soa(to_torch(tris.reshape(-1, 3, 3)))


@pytest.mark.parametrize("parts", [1, 2, 7, 32, 33])
@pytest.mark.parametrize("case", ["random", "sphere", "duplicated", "all dead", "t1", "t0"])
def test_split_winner_rule_matches_plain(case, parts):
    """The winners of contiguous parts of the triangles (K1's warps and
    cluster blocks), merged on (t, index), are the plain winner bitwise."""
    rays, tri_soa = _split_case(case)
    want_t, want_i = intersect.intersect_best_plain(rays, tri_soa)
    got_t, got_i = _split_best(rays, tri_soa, parts)
    assert got_i.dtype == torch.int32 and want_i.dtype == torch.int32
    assert torch.equal(got_t.view(torch.int32), want_t.view(torch.int32))
    assert torch.equal(got_i, want_i)
    hit = want_t < 1.5
    assert torch.equal(want_i[~hit], torch.zeros_like(want_i[~hit]))
    assert bool((want_t[~hit] == geometry.NO_HIT_T).all())
    if case in ("all dead", "t0"):
        assert not bool(hit.any())
    elif case == "t1":
        assert int(hit.sum()) > 300 and not bool(want_i.any())
    else:
        assert int(hit.sum()) > 20
    if case == "duplicated":  # rays whose winner has a twin at index + 300: the lower won
        assert int((hit & (want_i < 150)).sum()) > 10
