"""The batched frame on the CPU: one pass for B frames against B frames one
after another, and against the reference's ``vmap`` over frames.

``Simulator.render_frames`` traces B frames as B x N paths, marches them
into one (rf_rows, B x E) image and runs the postproc and the scan
conversion over the (B, ...) stack (``models/simulator.py:render_frames``).
Frame b must equal ``render_frame(seeds[b], position=positions[b],
angles=angles[b])``; on the CPU, where every stage runs its plain version,
bitwise: the draws, the segments, ``rf_raw``, ``rf_env`` and ``bmode``
(the plain scatter march adds a pixel's echoes in the same order in the
wide image as in one frame's, so no tolerance is needed there either).

Against the reference (``mcray_tpu``'s ``Simulator.render_batch`` and
``render_compound``, a jitted ``vmap``; its ``MaterialFitter`` step with
two frames, a ``vmap`` under ``value_and_grad``) the tolerances are the
whole-frame ones of ``tests/test_torch_slice.py`` (rtol 1e-4, atol 1e-5;
the B-mode clamped at 0 as the port's is) and, for the fit step's
material gradient, ``tests/test_torch_grad.py``'s (2e-3 of the largest
entry); the fit loss at rtol 1e-5. At 32 elements x 2 paths seeds 1-7 and
the keys ``split(PRNGKey(2), 2)`` trace no edge-grazing path; seed 0 and
``split(PRNGKey(1), 2)`` do, and the jitted reference parts from its own
op-by-op self there (``ROADMAP.md``, reference-side defects).

The module takes ~40 s on one CPU thread, a third of it the reference's two
compilations.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import SPHERE_SCENE, both_configs, reference_render_fn, to_np, to_torch
from mcray_tpu.models.simulator import Simulator as RefSimulator
from mcray_tpu.models.trainer import MaterialFitter as RefFitter
from mcray_tpu.scene.compile import load_and_compile as ref_load_and_compile
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.models.trainer import MaterialFitter, PoseFitter
from mcray_tpu_torch.ops import imaging, physics
from mcray_tpu_torch.ops.cuda import postproc, scanconv
from mcray_tpu_torch.probe import transducer
from mcray_tpu_torch.scene.compile import load_and_compile
from mcray_tpu_torch.utils import rng

SEEDS = (1, 2, 3)  # three frames that differ; none grazes an edge at 32 x 2
FRAME_KEYS = ("rf_raw", "rf_conv", "rf_env", "bmode", "segments_valid")


@functools.lru_cache(maxsize=None)
def _simulator(**overrides) -> Simulator:
    _, cfg = both_configs(transducer_elements=32, samples_per_element=2, **overrides)
    return Simulator(load_and_compile(SPHERE_SCENE), cfg, device="cpu", seed=1)


def _poses(sim, moved: bool):
    """Three poses: the scene's, or the scene's and two moved ones."""
    shift = torch.tensor([[0.0, 0.0, 0.0], [0.1, 0.0, 0.0], [0.0, 0.2, 0.0]])
    turn = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 3.0], [2.0, 0.0, 0.0]])
    if not moved:
        shift, turn = shift * 0, turn * 0
    return sim.position + shift, sim.angles + turn


@pytest.mark.parametrize("case,overrides,moved", [
    ("seeds at one pose", {}, False),
    ("three poses, log compression", {"log_compression": True}, True),
    ("three poses, centered PSF", {"centered_psf": True}, True),
])
def test_batched_frame_equals_a_loop_of_frames(case, overrides, moved):
    """B = 3 frames in one pass against three ``render_frame`` calls, bitwise:
    draws, every segment field, ``rf_raw``, ``rf_conv``, ``rf_env``,
    ``bmode`` and ``segments_valid``. Each frame's log compression takes
    its own maximum (a batch-wide one would fail the three poses' case). ~3 s."""
    sim = _simulator(**overrides)
    positions, angles = _poses(sim, moved)
    batch = sim.render_frames(list(SEEDS), positions=positions, angles=angles)
    frames = [sim.render_frame(s, position=positions[b], angles=angles[b])
              for b, s in enumerate(SEEDS)]

    draws = sim.batch_draws(list(SEEDS))
    for key, value in draws.items():
        assert torch.equal(value, torch.cat([sim.draws(s)[key] for s in SEEDS], dim=1)), key
    e = sim.cfg.transducer_elements
    for key, value in batch["segments"].items():
        dim = 2 if key == "rays" else 1
        parts = [f["segments"][key] + b * e if key == "element" else f["segments"][key]
                 for b, f in enumerate(frames)]
        assert torch.equal(value, torch.cat(parts, dim=dim)), key
    for key in FRAME_KEYS:
        assert batch[key].shape[0] == len(SEEDS), key
        for b, f in enumerate(frames):
            assert torch.equal(batch[key][b], f[key]), (key, b)
    # the three frames differ, so a read across a frame's edge would show
    assert not torch.equal(batch["bmode"][0], batch["bmode"][1])
    assert not torch.equal(batch["rf_env"][1], batch["rf_env"][2])
    if overrides.get("log_compression"):
        peaks = batch["rf_env"].amax(dim=(1, 2))
        assert torch.equal(peaks, torch.ones(3))  # each frame's own maximum maps to 1


def test_render_batch_and_compound_match_reference():
    """``Simulator.render_batch`` and ``render_compound`` against the
    reference's (one jitted ``vmap`` over the seeds' frames) at rtol 1e-4,
    atol 1e-5, and against the port's own frames bitwise. ~10 s."""
    ref_cfg, _ = both_configs(transducer_elements=32, samples_per_element=2)
    ref = RefSimulator(ref_load_and_compile(SPHERE_SCENE, ref_cfg, with_bvh=False), ref_cfg,
                       seed=1)
    sim = _simulator()
    want = np.maximum(np.asarray(ref.render_batch(list(SEEDS))), 0.0)
    got = sim.render_batch(list(SEEDS))
    assert got.shape == (len(SEEDS), sim.cfg.bmode_rows, sim.cfg.bmode_cols)
    np.testing.assert_allclose(to_np(got), want, rtol=1e-4, atol=1e-5)
    compound = sim.render_compound(list(SEEDS))
    np.testing.assert_allclose(to_np(compound), want.mean(axis=0), rtol=1e-4, atol=1e-5)
    assert torch.equal(compound, got.mean(dim=0))
    for b, s in enumerate(SEEDS):
        assert torch.equal(got[b], sim.render_frame(s)["bmode"])
    # keys as rng.split hands them out render the frames of those keys
    keys = rng.split(rng.prng_key(5), 2)
    assert torch.equal(sim.render_batch(keys)[1], sim.render_frame(keys[1])["bmode"])


def test_two_frame_fit_step_matches_reference():
    """One ``MaterialFitter`` step with ``n_frames_per_step=2`` (soft +
    trilinear, the doubled LIVER attenuation) against the reference fitter's
    step, whose two frames are a ``vmap`` under ``value_and_grad``: the
    loss at rtol 1e-5, the masked material gradient at 2e-3 of its largest
    entry. The port renders the two frames in one batched call; against the
    same fitter rendering them one after another the loss is bitwise and the
    gradient within 1e-6 of its largest entry (the two frames' contributions
    are summed inside the shared operations' backward in the batch, after
    each frame's backward in the loop: another order). ~15 s."""
    row, col = 3, physics.ATTENUATION
    ref_cfg, _ = both_configs(transducer_elements=32, samples_per_element=2,
                              soft_scattering=True, trilinear_texture=True)
    pack = ref_load_and_compile(SPHERE_SCENE, ref_cfg, with_bvh=False)
    ref_render, _ = reference_render_fn(ref_cfg, pack, 1)
    sim = _simulator(soft_scattering=True, trilinear_texture=True)
    with torch.no_grad():  # the target: the port's frame of seed 1 at the true materials
        target = to_np(sim.render_frame(1)["bmode"])
    start = pack.materials.copy()
    start[row, col] *= 2.0
    fit_kw = dict(learning_rate=5e-2, trainable=(col,), trainable_rows=[row],
                  n_frames_per_step=2)
    ref_fit = RefFitter(ref_render, jnp.asarray(start), jnp.asarray(target), **fit_kw)
    _, _, want_loss, want_grad = ref_fit._step(ref_fit.state.materials, ref_fit.state.opt_state,
                                               jax.random.PRNGKey(2))

    fit = MaterialFitter.from_simulator(sim, start, target.copy(), **fit_kw)
    loss = fit.step(rng.prng_key(2))
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    assert np.abs(want_grad).max() > 0
    np.testing.assert_allclose(to_np(fit.last_grad), want_grad, rtol=0,
                               atol=2e-3 * np.abs(want_grad).max())

    def render_fn(key, materials):
        return sim.render_frame(key, materials)["bmode"]

    looped = MaterialFitter(render_fn, torch.from_numpy(start), to_torch(target), **fit_kw)
    assert looped.step(rng.prng_key(2)) == loss
    grad = to_np(fit.last_grad)
    np.testing.assert_allclose(to_np(looped.last_grad), grad, rtol=0,
                               atol=1e-6 * np.abs(grad).max())


def test_fd_gradient_batched_equals_the_loop():
    """``PoseFitter.fd_gradient`` through ``from_simulator`` (the 7 points x
    2 keys in one batched call, frame p K + k at point p's pose with key k)
    against a fitter given only the per-frame render (the points one after
    another): point losses and gradient bitwise. ~5 s."""
    _, cfg = both_configs(transducer_elements=32, samples_per_element=1)
    sim = Simulator(load_and_compile(SPHERE_SCENE), cfg, device="cpu", seed=0)
    keys = rng.split(rng.prng_key(42), 2)

    def render(key, position, angles):
        return sim.render_frame(key, position=position, angles=angles)["bmode"]

    with torch.no_grad():
        target = PoseFitter.compound(render, keys, sim.position, sim.angles)
        assert torch.equal(target, sim.render_compound(keys))
    start = sim.position + torch.tensor([0.0, 0.3, 0.0])
    kw = dict(method="fd", keys=keys, scales=(4.0, 8.0))
    batched = PoseFitter.from_simulator(sim, start, sim.angles, target, **kw)
    looped = PoseFitter(render, start, sim.angles, target, **kw)
    vals, g = batched.fd_gradient(0.06)
    want_vals, want_g = looped.fd_gradient(0.06)
    assert vals.shape == (7,) and bool((vals > 0).all())
    assert torch.equal(vals, want_vals)
    assert torch.equal(g, want_g)


def test_batched_imaging_equals_each_frame():
    """``gaussian_blur``, ``log_compress``, ``element_layout``, the plain
    postproc (both PSFs, both envelopes) and the plain scan conversion and
    its backward, each over a leading frame axis, against the 2-D call per
    frame: bitwise. Three frames of different noise. <1 s."""
    _, cfg = both_configs(transducer_elements=32, samples_per_element=2)
    gen = np.random.default_rng(12)
    rf = to_torch(gen.standard_normal((3, cfg.rf_rows, cfg.rf_cols)), torch.float32)
    rf[1] *= 5.0
    frames = range(rf.shape[0])

    def each(fn, x):
        return torch.stack([fn(x[b]) for b in frames])

    for sigma in (2.0, 4.0):
        assert torch.equal(imaging.gaussian_blur(rf, sigma),
                           each(lambda x: imaging.gaussian_blur(x, sigma), rf))
    positive = rf.abs()
    assert torch.equal(imaging.log_compress(positive), each(imaging.log_compress, positive))
    for kw in ({}, {"centered_psf": True}, {"envelope_mode": "hilbert"}):
        c = both_configs(transducer_elements=32, samples_per_element=2, **kw)[1]
        assert torch.equal(postproc.postproc_plain(rf, c),
                           each(lambda x: postproc.postproc_plain(x, c), rf)), kw
    maps = scanconv.scan_maps(*imaging.scan_conversion_maps(cfg), cfg.rf_rows, cfg.rf_cols)
    assert torch.equal(scanconv.scan_convert_plain(rf, maps.table, maps.out_cols),
                       each(lambda x: scanconv.scan_convert_plain(x, maps.table, maps.out_cols), rf))
    assert torch.equal(scanconv.scan_convert_coords_plain(rf, maps.coords),
                       each(lambda x: scanconv.scan_convert_coords_plain(x, maps.coords), rf))
    g = to_torch(gen.standard_normal((3, cfg.bmode_rows, cfg.bmode_cols)), torch.float32)
    assert torch.equal(
        scanconv.scan_convert_bwd_plain(g, maps.table, cfg.rf_rows, cfg.rf_cols),
        each(lambda x: scanconv.scan_convert_bwd_plain(x, maps.table, cfg.rf_rows, cfg.rf_cols),
             g))
    # through the autograd Function: a (B, H, W) cotangent gives the (B, R, C) gradient
    x = rf.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(scanconv.scan_convert_cuda(x, maps), x, g)
    assert grad.shape == rf.shape

    for probe in ("convex", "linear", "phased"):
        c = both_configs(transducer_elements=32, samples_per_element=2, probe_type=probe)[1]
        pos = to_torch(gen.uniform(-1, 1, (3, 3)), torch.float32)
        ang = to_torch(gen.uniform(-10, 10, (3, 3)), torch.float32)
        got_p, got_d = transducer.element_layout(pos, ang, c)
        want = [transducer.element_layout(pos[b], ang[b], c) for b in frames]
        assert torch.equal(got_p, torch.cat([w[0] for w in want])), probe
        assert torch.equal(got_d, torch.cat([w[1] for w in want])), probe
