"""K1's plain version against the reference's Pallas brute intersect kernel.

``intersect_closest_pallas(..., interpret=True)`` runs the reference TPU
kernel on the CPU. The closest hit is discrete: hit/miss must be equal, and
where the winning t is unique the winner must be the same triangle (equal
mesh id and oriented normal). t is formula-identical up to XLA's FMA
contraction: rtol 1e-5, atol 1e-7, the reference's own kernel tolerance.
The CUDA kernel itself is held against this plain version on the card
(chip_smoke.py, tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import SPHERE_SCENE, random_segments, random_triangles, to_np, to_torch
from mcray_tpu.ops.pallas.intersect import intersect_closest_pallas
from mcray_tpu_torch.config import small_test_config
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.ops import geometry
from mcray_tpu_torch.ops.cuda import intersect
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
    before = intersect.launches
    best_t, best_idx = intersect.intersect_best(rays.T.contiguous(), tri_soa)
    want_t, want_idx = intersect.intersect_best_plain(rays.T.contiguous(), tri_soa)
    assert intersect.launches == before
    assert best_idx.dtype == torch.int32
    assert torch.equal(best_t, want_t) and torch.equal(best_idx, want_idx)
