"""Shared set-up of the tests that hold mcray_tpu_torch against mcray_tpu.

Both packages run in one process: JAX on the CPU (tests/conftest.py), torch
on the CPU with one thread (the suite runs several xdist workers), and data
crosses between them as numpy arrays made from a seed.
"""

from __future__ import annotations

import os

import numpy as np
import torch

torch.set_num_threads(1)

SPHERE_SCENE = os.path.join(os.path.dirname(__file__), "..", "assets", "sphere", "sphere.scene")


def to_torch(x, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype)


def to_np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def random_triangles(rng: np.random.Generator, t: int):
    """(T, 3, 3) f32 triangles scattered in a 10-unit box, and (T,) mesh ids."""
    centers = rng.uniform(-5, 5, (t, 1, 3))
    tris = (centers + rng.standard_normal((t, 3, 3)) * 0.8).astype(np.float32)
    return tris, rng.integers(0, 6, (t,)).astype(np.int32)


def random_segments(rng: np.random.Generator, n: int):
    """(N, 3) origins and (N, 3) segment vectors through that box."""
    origins = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    segs = (rng.standard_normal((n, 3)) * 8).astype(np.float32)
    return origins, segs


def reference_draws(seed: int, n: int, n_depth: int) -> dict[str, np.ndarray]:
    """The reference frame's per-bounce draws for ``seed``: the path keys are
    fold_in(fold_in(PRNGKey(seed), 0), path id) (simulator.py:100, :372)."""
    import jax
    import jax.numpy as jnp

    from mcray_tpu.ops import physics

    k_trace = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    path_keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        k_trace, jnp.arange(n, dtype=jnp.uint32)
    )
    return {k: np.asarray(v) for k, v in physics.draw_bounce_randoms(path_keys, n_depth).items()}
