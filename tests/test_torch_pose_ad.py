"""The pose gradient of the port against ``jax.grad`` of the reference, on the CPU.

d(pixel MSE)/d(position) and d/d(angles) of one frame at
``small_test_config(32 elements, 1 sample)`` in soft + trilinear mode, from
the +0.3 offset, the reference's draws of seed 0 on both sides. Tolerance:
the loss at rtol 1e-4, each gradient at atol 5e-3 x its largest entry
(``tests/test_torch_grad.py`` holds the material gradient at 2e-3; the pose
gradient also crosses the trace's geometry, the probe layout's rotations and
every segment's end points, where the two packages round apart).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port import (SPHERE_SCENE, both_configs, port_render_fn, reference_draws,
                         reference_render_fn, to_np, to_torch)
from mcray_tpu.scene.compile import load_and_compile as ref_load_and_compile

OFFSET = np.array([0.0, 0.3, 0.0], np.float32)


def test_ad_pose_gradient_matches_reference():
    """d(pixel MSE)/d(position) and d/d(angles) of one frame from the +0.3
    offset, soft + trilinear, the reference's draws of seed 0."""
    ref_cfg, cfg = both_configs(transducer_elements=32, samples_per_element=1,
                                soft_scattering=True, trilinear_texture=True)
    pack = ref_load_and_compile(SPHERE_SCENE, ref_cfg, with_bvh=False)
    n = cfg.transducer_elements * cfg.samples_per_element
    ref_render, seeds = reference_render_fn(ref_cfg, pack, 0)
    key = jax.random.PRNGKey(0)
    mats = jnp.asarray(pack.materials)
    true_pos, ang = pack.transducer_position, pack.transducer_angles
    target = np.asarray(ref_render(key, mats))
    start = true_pos + OFFSET

    def ref_loss(pos, a):
        return jnp.mean((ref_render(key, mats, pos, a) - target) ** 2)

    want_loss, want = jax.jit(jax.value_and_grad(ref_loss, argnums=(0, 1)))(
        jnp.asarray(start), jnp.asarray(ang))
    want_loss, want = float(want_loss), [np.asarray(g) for g in want]
    render = port_render_fn(cfg, pack, seeds, reference_draws(0, n, cfg.max_depth))
    pos = to_torch(start).requires_grad_(True)
    a = to_torch(ang).requires_grad_(True)
    loss = torch.mean((render(None, to_torch(pack.materials), pos, a) - to_torch(target)) ** 2)
    got = [to_np(g) for g in torch.autograd.grad(loss, (pos, a))]

    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-4)
    for g, w in zip(got, want):
        assert np.isfinite(g).all() and np.abs(w).max() > 0
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-3 * np.abs(w).max())
