"""Gradients of the port against the reference's, on the CPU: the plain
stages the fit differentiates through (postproc, texture lookup), the three
NaN hazards of a backward pass through the tracer (a dead ray's zero
segment, a total-internal-reflection lane, the ray length), and the whole
slice: d(loss)/d(materials) of one frame.

Inputs come from numpy seeds and the reference's own per-bounce draws, so
both packages differentiate the same function at the same point. Each test
states its tolerance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (SPHERE_SCENE, both_configs, port_render_fn, reference_draws,
                         reference_render_fn, to_np, to_torch)
from mcray_tpu.models import simulator as ref_sim
from mcray_tpu.ops import geometry as ref_geometry
from mcray_tpu.ops import imaging as ref_imaging
from mcray_tpu.ops import physics as ref_physics
from mcray_tpu.ops import texture as ref_texture
from mcray_tpu.scene.compile import load_and_compile as ref_load_and_compile
from mcray_tpu_torch.models import simulator
from mcray_tpu_torch.ops import geometry, physics, texture
from mcray_tpu_torch.ops.cuda import postproc
from mcray_tpu_torch.utils.convert import from_reference


def _grad_torch(fn, *arrays):
    xs = [to_torch(a).requires_grad_(True) for a in arrays]
    return [to_np(g) for g in torch.autograd.grad(fn(*xs), xs, allow_unused=True)]


def test_postproc_backward_matches_reference(rng):
    """The postproc ``Function``'s backward (autograd over the plain
    convolution + envelope) against ``jax.vjp`` of the reference's: rtol
    1e-4, atol 1e-5, the reference's own tolerance for this stage
    (``tests/test_grad_pallas.py``)."""
    ref_cfg, cfg = both_configs()
    rf = rng.standard_normal((cfg.rf_rows, cfg.rf_cols)).astype(np.float32)
    g = rng.standard_normal(rf.shape).astype(np.float32)
    want = jax.jit(lambda x, ct: jax.vjp(
        lambda y: ref_imaging.envelope(ref_imaging.convolve_psf(y, ref_cfg)), x)[1](ct)[0])(
            jnp.asarray(rf), jnp.asarray(g))
    x = to_torch(rf).requires_grad_(True)
    (got,) = torch.autograd.grad(postproc.postproc_cuda(x, cfg), x, to_torch(g))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert np.abs(to_np(got)).max() > 0.1


def test_soft_trilinear_scattering_gradients_match_reference(rng):
    """``get_scattering`` in soft + trilinear mode: gradients w.r.t. mu0,
    mu1, sigma and the points, with points on both sides of the power-of-two
    wrap (below 0 and beyond size x res). rtol 1e-4, atol 1e-4 x max: the
    sigmoid's derivative at tau = 0.05 multiplies ulp differences by 1/tau."""
    ref_cfg, cfg = both_configs(soft_scattering=True, trilinear_texture=True)
    n = 4000
    extent = cfg.volume_size * cfg.resolution_um / 1000.0
    points = rng.uniform(-1.5 * extent, 2.5 * extent, (n, 3)).astype(np.float32)
    mu0 = rng.uniform(0.0, 1.0, n).astype(np.float32)
    mu1 = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    sigma = rng.uniform(0.1, 1.0, n).astype(np.float32)
    w = rng.standard_normal(n).astype(np.float32)
    seeds = np.array([12345, 67890], np.int64)

    def ref_loss(mu0, mu1, sigma, points):
        vol = {"seeds": jnp.asarray(seeds, jnp.uint32)}
        return jnp.sum(ref_texture.get_scattering(vol, mu1, mu0, sigma, points, ref_cfg) * w)

    def port_loss(mu0, mu1, sigma, points):
        vol = {"seeds": torch.from_numpy(seeds)}
        return torch.sum(texture.get_scattering(vol, mu1, mu0, sigma, points, cfg) * to_torch(w))

    want = jax.grad(ref_loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (mu0, mu1, sigma, points)))
    got = _grad_torch(port_loss, mu0, mu1, sigma, points)
    for name, g, r in zip(("mu0", "mu1", "sigma", "points"), got, want):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4 * np.abs(r).max(), err_msg=name)
        assert np.abs(r).max() > 0, name


def test_zero_segment_has_a_finite_zero_gradient():
    """A dead ray's zero segment: the norm and the mm distance at a zero
    vector have the reference's gradient (exactly 0), not sqrt'(0) = inf."""
    v = np.array([[0.0, 0.0, 0.0], [3.0, 4.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    want = np.asarray(jax.grad(lambda x: jnp.sum(ref_geometry.safe_norm(x)))(jnp.asarray(v)))
    (got,) = _grad_torch(lambda x: geometry.safe_norm(x).sum(), v)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all() and (got[0] == 0).all() and got[1, 0] == np.float32(0.6)
    spacing = np.array([1.0, 1.0, 1.0], np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(ref_sim.distance_in_mm(
        a, jnp.asarray(v), jnp.asarray(spacing))))(jnp.asarray(v)))
    (got,) = _grad_torch(lambda a: geometry.distance_in_mm(a, to_torch(v), to_torch(spacing)).sum(), v)
    np.testing.assert_array_equal(got, want)
    assert (got == 0).all()
    # where a later ``where`` masks the lane, the gradient stays 0 and not NaN
    (got,) = _grad_torch(lambda x: torch.where(torch.tensor([False, True, False]),
                                               geometry.safe_norm(x), 0.0).sum(), v)
    assert np.isfinite(got).all()


def test_total_internal_reflection_lanes_have_finite_gradients(rng):
    """``hit_boundary`` with lanes under total internal reflection: the
    material gradient is finite and equals the reference's (rtol 1e-4, atol
    1e-5 x max; the double ``where`` around the refraction sqrt)."""
    ref_cfg, cfg = both_configs()
    pack = ref_load_and_compile(SPHERE_SCENE, ref_cfg, with_bvh=False)
    n = 512
    m, k = pack.n_materials, pack.mesh_mat_inside.shape[0]
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    inputs = (d, rng.uniform(-5, 5, (n, 3)).astype(np.float32), nrm,
              rng.uniform(1e-6, 0.5, n).astype(np.float32),
              rng.integers(0, m, n).astype(np.int32), np.full(n, -1, np.int32),
              rng.integers(0, k, n).astype(np.int32))
    tables = (pack.mesh_mat_inside, pack.mesh_mat_outside, pack.mesh_is_vascular)
    draws = {key: v[3] for key, v in reference_draws(5, n, 4).items()}
    w = rng.standard_normal((3, n)).astype(np.float32)

    def ref_loss(materials):
        hb = ref_physics.hit_boundary(
            None, *map(jnp.asarray, inputs), materials, *map(jnp.asarray, tables), ref_cfg,
            draws={key: jnp.asarray(v) for key, v in draws.items()})
        return (jnp.sum(hb["back_intensity"] * w[0]) + jnp.sum(hb["new_intensity"] * w[1])
                + jnp.sum(hb["new_direction"][:, 0] * w[2])), hb

    def port_hb(materials):
        return physics.hit_boundary(
            *map(to_torch, inputs), materials, *map(to_torch, tables), cfg,
            draws={key: to_torch(v) for key, v in draws.items()})

    def port_loss(materials):
        hb = port_hb(materials)
        wt = to_torch(w)
        return ((hb["back_intensity"] * wt[0]).sum() + (hb["new_intensity"] * wt[1]).sum()
                + (hb["new_direction"][:, 0] * wt[2]).sum())

    # lanes under total internal reflection exist: all of the intensity is
    # reflected, so the ray continues reflected with its intensity unchanged
    rows = pack.materials
    hb = port_hb(to_torch(rows))
    tir_lanes = int((to_np(hb["new_intensity"]) == inputs[3]).sum())
    assert tir_lanes > 10
    want, _ = jax.grad(ref_loss, has_aux=True)(jnp.asarray(rows))
    (got,) = _grad_torch(port_loss, rows)
    assert np.isfinite(got).all()
    want = np.asarray(want)
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def traced():
    """The reference's and the port's tracer inputs for seed 2 at 16 x 2."""
    ref_cfg, cfg = both_configs(transducer_elements=16, samples_per_element=2)
    pack = ref_load_and_compile(SPHERE_SCENE, ref_cfg, with_bvh=False)
    n = cfg.transducer_elements * cfg.samples_per_element
    state = from_reference(pack, pack.materials, np.zeros(2), reference_draws(2, n, cfg.max_depth),
                           device="cpu")
    return ref_cfg, cfg, pack, state


def test_ray_length_is_detached_in_the_trace(traced, rng):
    """The segment end points of rays that miss are ``dest``, which the ray
    length sets: detached, their material gradient is the reference's
    (zero through ``dest``) and finite, where the attached f32 gradient is
    ~1e7 x noise. Also: the trace's gradient through hit points, intensities
    and distances equals the reference's (rtol 1e-3, atol 1e-4 x max: the
    hit-geometry backward amplifies ulp differences)."""
    ref_cfg, cfg, pack, state = traced
    fields = ("to", "reflected", "initial", "distance")
    shapes = {"to": (cfg.max_depth, 32, 3)}
    w = {f: rng.standard_normal(shapes.get(f, (cfg.max_depth, 32))).astype(np.float32)
         for f in fields}
    scene = {key: jnp.asarray(v) for key, v in pack.trace_tables().items()}

    def ref_loss(materials):
        seg = ref_sim.trace_paths(
            jax.random.fold_in(jax.random.PRNGKey(2), 0), materials,
            jnp.asarray(pack.transducer_position), jnp.asarray(pack.transducer_angles), scene,
            jnp.asarray(pack.spacing), jnp.int32(pack.starting_material), ref_cfg)
        valid = seg["valid"]
        return sum(jnp.sum(jnp.where(valid.reshape(valid.shape + (1,) * (seg[f].ndim - 2)),
                                     seg[f], 0.0) * w[f]) for f in fields)

    def port_loss(materials):
        seg = simulator.trace_paths(
            state["draws"], materials, state["position"], state["angles"], state["scene"],
            state["spacing"], state["starting_material"], cfg)
        valid = seg["valid"]
        return sum((torch.where(valid.reshape(valid.shape + (1,) * (seg[f].ndim - 2)),
                                seg[f], 0.0) * to_torch(w[f])).sum() for f in fields)

    want = np.asarray(jax.grad(ref_loss)(jnp.asarray(pack.materials)))
    (got,) = _grad_torch(port_loss, pack.materials)
    assert np.isfinite(got).all() and np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max())
    # the gradient through the missing rays' end points alone is exactly zero
    def miss_loss(materials):
        seg = simulator.trace_paths(
            state["draws"], materials, state["position"], state["angles"], state["scene"],
            state["spacing"], state["starting_material"], cfg)
        miss = seg["valid"] & (seg["reflected"] == 0)
        return torch.where(miss[..., None], seg["to"] - seg["from"].detach(), 0.0).sum()

    (got,) = _grad_torch(miss_loss, pack.materials)
    assert (got[:, physics.ATTENUATION] == 0).all()


def test_frame_material_gradient_matches_reference():
    """The whole slice: d(pixel MSE)/d(materials) of one frame at
    ``small_test_config(soft_scattering=True, trilinear_texture=True)`` with
    the doubled LIVER attenuation, through the port's Functions (plain
    versions on the CPU) against ``jax.grad`` through the reference's render
    with the same draws. Tolerance: 2e-3 x the largest entry, the
    reference's own composed tolerance in trilinear mode
    (``tests/test_grad_pallas.py:83``). Seed 0 traces no edge-grazing path at
    this size (``tests/test_torch_slice.py``), so no path is set aside; the
    loss itself agrees to rtol 1e-4."""
    ref_cfg, cfg = both_configs(soft_scattering=True, trilinear_texture=True)
    pack = ref_load_and_compile(SPHERE_SCENE, ref_cfg, with_bvh=False)
    n = cfg.transducer_elements * cfg.samples_per_element
    ref_render, seeds = reference_render_fn(ref_cfg, pack, 0)
    key = jax.random.PRNGKey(0)
    target = np.asarray(ref_render(key, jnp.asarray(pack.materials)))
    start = pack.materials.copy()
    start[3, physics.ATTENUATION] *= 2.0

    want_loss, want = jax.value_and_grad(
        lambda m: jnp.mean((ref_render(key, m) - target) ** 2))(jnp.asarray(start))
    render = port_render_fn(cfg, pack, seeds, reference_draws(0, n, cfg.max_depth))
    mats = to_torch(start).requires_grad_(True)
    loss = torch.mean((render(None, mats) - to_torch(target)) ** 2)
    (got,) = torch.autograd.grad(loss, mats)

    want = np.asarray(want)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-4)
    assert np.isfinite(to_np(got)).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(to_np(got), want, atol=2e-3 * np.abs(want).max(), rtol=0)
    assert abs(to_np(got)[3, physics.ATTENUATION]) > 0
