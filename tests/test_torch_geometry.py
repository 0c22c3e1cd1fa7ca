"""mcray_tpu_torch geometry and probe layouts against mcray_tpu.

The closest hit is discrete, so hit/miss and the winner's mesh id must be
equal. The formulas are the same, but XLA's CPU code contracts multiply-adds
into FMAs under jit where torch rounds each op, and the cancellations of
Möller–Trumbore amplify that last-ulp difference: t compares at rtol 1e-5,
atol 1e-7, the point and normal at atol 1e-5 — the tolerances of the
reference's own kernel test (tests/test_pallas_intersect.py). Layouts go
through sin/cos: rtol 1e-5, atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import both_configs, random_segments, random_triangles, to_np, to_torch
from mcray_tpu.ops import geometry as ref
from mcray_tpu.probe import transducer as ref_probe
from mcray_tpu_torch.ops import geometry
from mcray_tpu_torch.probe import transducer


def test_moller_trumbore_matches(rng):
    tris, _ = random_triangles(rng, 64)
    o, _ = random_segments(rng, 96)
    # aim ray i through the centroid of triangle i % 64, so every ray hits one
    s = (2.0 * (tris.mean(axis=1)[np.arange(96) % 64] - o)).astype(np.float32)
    v0, e1, e2 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    args = (o[:, None], s[:, None], v0[None], e1[None], e2[None])
    t_ref, ok_ref = ref._moller_trumbore(*(jnp.asarray(a) for a in args))
    t, ok = geometry._moller_trumbore(*(to_torch(a) for a in args))
    ok_ref = np.asarray(ok_ref)
    np.testing.assert_array_equal(to_np(ok), ok_ref)
    assert ok_ref.sum() > 100
    # t of the hits only: off them near-zero determinants blow t up, and the
    # callers discard it
    np.testing.assert_allclose(to_np(t)[ok_ref], np.asarray(t_ref)[ok_ref], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("chunk", [4096, 37], ids=["one-chunk", "ragged-chunks"])
def test_intersect_closest_matches(rng, chunk):
    tris, mid = random_triangles(rng, 700)
    o, s = random_segments(rng, 300)
    want = {k: np.asarray(v) for k, v in ref.intersect_closest(
        jnp.asarray(o), jnp.asarray(s), jnp.asarray(tris), jnp.asarray(mid)).items()}
    got = {k: to_np(v) for k, v in geometry.intersect_closest(
        to_torch(o), to_torch(s), to_torch(tris), to_torch(mid), chunk=chunk).items()}
    assert want["hit"].any() and not want["hit"].all()
    np.testing.assert_array_equal(got["hit"], want["hit"])
    np.testing.assert_array_equal(got["mesh_id"], want["mesh_id"])
    np.testing.assert_allclose(got["t"], want["t"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["point"], want["point"], atol=1e-5)
    np.testing.assert_allclose(got["normal"], want["normal"], atol=1e-5)


def test_parked_dead_rays_miss(rng):
    tris, mid = random_triangles(rng, 100)
    o = np.full((8, 3), 1e9, np.float32)
    hits = geometry.intersect_closest(to_torch(o), torch.zeros(8, 3), to_torch(tris), to_torch(mid))
    assert not hits["hit"].any()
    assert (hits["mesh_id"] == -1).all()


@pytest.mark.parametrize("probe", ["convex", "linear", "phased"])
def test_element_layout_matches(probe):
    ref_cfg, cfg = both_configs(probe_type=probe)
    pos = np.array([0.5, -1.0, 2.0], np.float32)
    ang = np.array([10.0, -20.0, 35.0], np.float32)
    want = ref_probe.element_layout(jnp.asarray(pos), jnp.asarray(ang), ref_cfg)
    got = transducer.element_layout(to_torch(pos), to_torch(ang), cfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (cfg.transducer_elements, 3)
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-5, atol=1e-6)
