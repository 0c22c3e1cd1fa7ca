"""Pose registration of the port against the reference's, on the CPU.

- ``gaussian_blur`` against the reference's at sigma 2, 4 and 8 on a 100 x
  125 image: allclose at rtol 1e-6, atol 1e-6 (the kernel's ``exp`` and sum
  round an ulp apart).
- The fd method's defaults and target bank against the reference's
  (blurred at rtol 1e-6, atol 1e-6).
- The fd update schedule: six fixed gradients through ``apply_fd_update``
  across two ``run`` calls. The rates equal ``optax.exponential_decay``'s
  (rtol 1e-7); the poses equal Adam's arithmetic in float64 at those rates
  to 2 ulp of float32 (rtol 2.5e-7: the poses are float32, updated six
  times), and ``optax.adam`` itself at atol 2e-6: optax rounds its bias
  corrections in float32 (1 - 0.999 = 0.00099998713), which moves its first
  update by 6.4e-6 relative, where ``torch.optim.Adam`` takes them in float64.
- Two fd steps, port against reference, on the sphere from the +0.3 offset
  at ``small_test_config(32 elements, 1 sample)``, keys
  ``split(prng_key(42), 2)``, scales (4, 8): the 7 point losses of each step
  at rtol 1e-4, the gradient at atol 1e-3 x its largest entry, and the
  positions after the steps at atol 1e-5 on every axis where the
  reference's |g| exceeds 1% of its largest (Adam's first update is
  lr * sign(g): a near-zero axis may flip and move 2 lr). The reference's
  frames are rendered op by op (see the test).
- The ad fitter: steps from a ``Simulator`` with ``fit_angles`` and
  ``soft_row_binning``, gradients finite and non-zero on position and
  angles, and the keying of an unfixed run. Its gradient against
  ``jax.grad`` of the reference is ``tests/test_torch_pose_ad.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import SPHERE_SCENE, both_configs, reference_render_fn, to_np, to_torch
from mcray_tpu.models.trainer import PoseFitter as RefPoseFitter
from mcray_tpu.ops.imaging import gaussian_blur as ref_gaussian_blur
from mcray_tpu.scene.compile import load_and_compile as ref_load_and_compile
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.models.trainer import FitState, PoseFitter
from mcray_tpu_torch.ops.imaging import gaussian_blur
from mcray_tpu_torch.scene.compile import load_and_compile
from mcray_tpu_torch.utils import rng

OFFSET = np.array([0.0, 0.3, 0.0], np.float32)


@pytest.mark.parametrize("sigma", [2.0, 4.0, 8.0])
def test_gaussian_blur_matches_reference(sigma):
    img = np.random.default_rng(3).random((100, 125)).astype(np.float32)
    want = np.asarray(ref_gaussian_blur(jnp.asarray(img), sigma))
    got = to_np(gaussian_blur(to_torch(img), sigma))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the edge padding keeps a constant image constant
    flat = gaussian_blur(torch.full((20, 30), 0.5), sigma)
    np.testing.assert_allclose(to_np(flat), 0.5, rtol=1e-6)


def _adam_f64(x, grads, rates):
    """Adam's arithmetic (optax.adam's formula) in float64."""
    x, m, v = x.astype(np.float64), np.zeros(3), np.zeros(3)
    out = []
    for t, (g, lr) in enumerate(zip(grads, rates), start=1):
        g = g.astype(np.float64)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        x = x - lr * (m / (1 - 0.9**t)) / (np.sqrt(v / (1 - 0.999**t)) + 1e-8)
        out.append(x)
    return out


def test_fd_schedule_and_adam_match_optax():
    grads = (np.random.default_rng(0).standard_normal((6, 3))
             * np.array([1e-3, 1.0, 50.0])).astype(np.float32)
    x0 = np.array([0.5, -1.7, 3.2], np.float32)
    schedule = optax.exponential_decay(5e-2, 1, 0.95)
    opt = optax.adam(schedule)
    x, st, want = jnp.asarray(x0), opt.init(jnp.asarray(x0)), []
    for g in grads:
        u, st = opt.update(jnp.asarray(g), st, x)
        x = optax.apply_updates(x, u)
        want.append(np.asarray(x))

    fit = PoseFitter(lambda k, p, a: torch.zeros((8, 8)), torch.from_numpy(x0), torch.zeros(3),
                     torch.ones((8, 8)), method="fd", keys=rng.split(rng.prng_key(42), 1))
    feed, deltas, rates, got = iter(grads), [], [], []

    def fd_gradient(delta):  # no render: the next fixed gradient
        deltas.append(delta)
        return torch.zeros(7), torch.from_numpy(next(feed))

    fit.fd_gradient = fd_gradient
    update = fit.apply_fd_update

    def apply_fd_update(g):
        update(g)
        rates.append(fit.optimizer.param_groups[0]["lr"])
        got.append(to_np(fit.position))

    fit.apply_fd_update = apply_fd_update
    assert len(fit.run(3, verbose=False)) == 3
    assert len(fit.run(3, verbose=False)) == 3

    np.testing.assert_allclose(rates, [float(schedule(k)) for k in range(6)], rtol=1e-7)
    np.testing.assert_allclose(np.stack(got), np.stack(_adam_f64(x0, grads, rates)), rtol=2.5e-7)
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=0, atol=2e-6)
    # the delta restarts on each run call; the update count carries across them
    assert deltas[:3] == deltas[3:] == [float(np.float32(max(0.025, 0.06 * 0.95**i)))
                                        for i in range(3)]
    state = fit.state
    assert isinstance(state, FitState) and state.step == 6 and state.opt_state["step"] == 6
    assert set(state.materials) == {"position"} and torch.equal(fit.angles, torch.zeros(3))


def test_fd_defaults_match_reference():
    """The fd method's defaults (keys, scales, deltas, rate) and its target
    bank (the blurred target / tmax) are the reference's."""
    target = np.random.default_rng(1).random((40, 50)).astype(np.float32) * 3.0
    ref = RefPoseFitter(None, jnp.zeros(3), jnp.zeros(3), jnp.asarray(target), method="fd")
    fit = PoseFitter(None, torch.zeros(3), torch.zeros(3), to_torch(target), method="fd")
    np.testing.assert_array_equal(to_np(fit.keys), np.asarray(ref._keys))
    assert fit.scales == ref._scales == (2.0, 4.0, 8.0) and fit.fd == ref._fd
    assert fit.learning_rate == 5e-2 and fit.lr_decay == 0.95 and not fit.fit_angles
    tmax = float(target.max())
    for s, bank in zip(fit.scales, fit._target_bank):
        want = np.asarray(ref_gaussian_blur(jnp.asarray(target) / tmax, s))
        np.testing.assert_allclose(to_np(bank), want, rtol=1e-6, atol=1e-6)


def _reference_fd(render, keys, target, scales, learning_rate):
    """The reference's fd step (``mcray_tpu/models/trainer.py:259-319``) from
    its own pieces (``gaussian_blur``, the compound mean, the central
    difference, ``optax.adam(exponential_decay)``) with each frame rendered
    op by op: ``step(vec, opt_state, delta) -> (vec, opt_state, vals, g)``
    and the optimiser's initial state."""
    tmax = float(np.maximum(np.max(target), 1e-20))
    bank = [ref_gaussian_blur(jnp.asarray(target) / tmax, s) for s in scales]
    opt = optax.adam(optax.exponential_decay(learning_rate, 1, 0.95))

    def loss(vec, ang):
        c = jnp.stack([render(k, vec, ang) for k in keys]).mean(0) / tmax
        return sum(jnp.mean((ref_gaussian_blur(c, s) - tb) ** 2) for s, tb in zip(scales, bank))

    def step(vec, opt_state, delta, ang):
        eye = jnp.eye(3, dtype=jnp.float32) * jnp.float32(delta)
        pts = jnp.concatenate([vec[None], vec[None] + eye, vec[None] - eye], 0)
        vals = jnp.stack([loss(p, ang) for p in pts])
        g = (vals[1:4] - vals[4:]) / (2.0 * jnp.full((3,), delta, jnp.float32))
        updates, opt_state = opt.update(g, opt_state, vec)
        return optax.apply_updates(vec, updates), opt_state, vals, g

    return step, opt.init


def test_two_fd_steps_match_reference():
    """Two fd steps from the +0.3 offset at ``small_test_config(32 elements,
    1 sample)``, keys ``split(prng_key(42), 2)``, scales (4, 8). The
    reference's frames are rendered op by op: jitted, its fused
    Möller–Trumbore parts from the op-by-op one on rays that graze a
    triangle edge, and this fan grazes some (``ROADMAP.md``, reference-side
    defects); op by op the port renders its frames."""
    ref_cfg, cfg = both_configs(transducer_elements=32, samples_per_element=1)
    pack = ref_load_and_compile(SPHERE_SCENE, ref_cfg, with_bvh=False)
    render, _ = reference_render_fn(ref_cfg, pack, 0)
    materials = jnp.asarray(pack.materials)
    ref_render = lambda k, p, a: render(k, materials, p, a)
    sim = Simulator(load_and_compile(SPHERE_SCENE), cfg, device="cpu", seed=0)
    keys = rng.split(rng.prng_key(42), 2)
    ref_keys = jax.random.split(jax.random.PRNGKey(42), 2)
    np.testing.assert_array_equal(to_np(keys), np.asarray(ref_keys))
    true_pos, ang = pack.transducer_position, pack.transducer_angles
    start = true_pos + OFFSET
    scales, lr = (4.0, 8.0), 2.5e-2

    with jax.disable_jit():
        ref_target = np.asarray(jnp.stack([ref_render(k, jnp.asarray(true_pos),
                                                      jnp.asarray(ang)) for k in ref_keys]).mean(0))
    render_fn = lambda k, p, a: sim.render_frame(k, position=p, angles=a)["bmode"]
    with torch.no_grad():
        target = PoseFitter.compound(render_fn, keys, torch.from_numpy(true_pos),
                                     torch.from_numpy(ang))
    np.testing.assert_allclose(to_np(target), ref_target, rtol=1e-4, atol=1e-5)
    fit = PoseFitter.from_simulator(sim, start, ang, target, keys=keys, learning_rate=lr,
                                    method="fd", scales=scales)

    step, init = _reference_fd(ref_render, ref_keys, ref_target, scales, lr)
    vec = jnp.asarray(start)
    opt_state = init(vec)
    for i in range(2):
        delta = float(np.float32(max(0.025, 0.06 * 0.95**i)))
        with jax.disable_jit():
            vec, opt_state, want_vals, want_g = step(vec, opt_state, delta, jnp.asarray(ang))
        vals, g = fit.fd_gradient(delta)
        fit.apply_fd_update(g)
        np.testing.assert_allclose(to_np(vals), np.asarray(want_vals), rtol=1e-4)
        want_g = np.asarray(want_g)
        np.testing.assert_allclose(to_np(g), want_g, rtol=0, atol=1e-3 * np.abs(want_g).max())
        strong = np.abs(want_g) > 0.01 * np.abs(want_g).max()
    np.testing.assert_allclose(to_np(fit.position)[strong], np.asarray(vec)[strong], atol=1e-5)
    assert strong.any() and fit.state.step == 2
    assert not np.allclose(to_np(fit.position), start)


def test_ad_fitter_steps_and_soft_row_binning():
    """The ad fitter from a ``Simulator`` (fixed key, fit_angles): each step's
    gradient reaches position and angles, finite and non-zero, with
    ``soft_row_binning`` (the scatter march) on; the keying of an unfixed
    run is ``fold_in(prng_key(seed), step)``."""
    _, cfg = both_configs(transducer_elements=32, samples_per_element=1, soft_scattering=True,
                          trilinear_texture=True, soft_row_binning=True)
    sim = Simulator(load_and_compile(SPHERE_SCENE), cfg, device="cpu", seed=0)
    key = rng.prng_key(3)
    with torch.no_grad():
        target = sim.render_frame(key)["bmode"]
    start = sim.position.cpu().numpy() + OFFSET
    fit = PoseFitter.from_simulator(sim, start, sim.angles, target, learning_rate=3e-2,
                                    fixed_key=key, fit_angles=True)
    losses = fit.run(2, verbose=False)
    assert np.isfinite(losses).all() and fit.state.step == 2
    g = to_np(fit.last_grad)
    assert g.shape == (6,) and np.isfinite(g).all() and (np.abs(g[:3]) > 0).any()
    assert (np.abs(g[3:]) > 0).any()
    assert set(fit.state.materials) == {"position", "angles"}
    assert not np.allclose(to_np(fit.position), start)

    seen = []
    fit.fixed_key = None
    fit.render_fn = lambda k, p, a: (seen.append(to_np(k)), sim.render_frame(
        k, position=p, angles=a)["bmode"])[1]
    fit.run(1, seed=5, verbose=False)
    np.testing.assert_array_equal(seen[0], to_np(rng.fold_in(rng.prng_key(5), 2)))
    with pytest.raises(ValueError, match="method"):
        PoseFitter(fit.render_fn, start, sim.angles, target, method="newton")
