"""Shared set-up of the tests that hold mcray_tpu_torch against mcray_tpu.

Both packages run in one process: JAX on the CPU (tests/conftest.py), torch
on the CPU with one thread (the suite runs several xdist workers), and data
crosses between them as numpy arrays made from a seed.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import torch

torch.set_num_threads(1)

SPHERE_SCENE = os.path.join(os.path.dirname(__file__), "..", "assets", "sphere", "sphere.scene")
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SHARD_WORKER = os.path.join(os.path.dirname(__file__), "torch_shard_worker.py")
SHARD_WORKER_TIMEOUT_S = 300


def to_torch(x, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype)


def to_np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


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


def both_configs(small: bool = True, **overrides):
    """(reference cfg, port cfg): each package's own ``SimConfig`` built from
    the same keyword arguments (the reference caches its ops by its own
    config object; the port imports nothing of the reference)."""
    from mcray_tpu import config as ref_config
    from mcray_tpu_torch import config as port_config

    if small:
        return ref_config.small_test_config(**overrides), port_config.small_test_config(**overrides)
    return ref_config.SimConfig(**overrides), port_config.SimConfig(**overrides)


def reference_render_fn(ref_cfg, pack, seed: int):
    """``render(key, materials, position=None, angles=None) -> bmode``
    through the reference's plain pipeline on the CPU (the scene's pose
    unless one is given), with the texture volume the port's ``Simulator``
    would derive for ``seed``; also returns that volume's seeds."""
    import jax
    import jax.numpy as jnp

    from mcray_tpu.models import simulator as ref_sim
    from mcray_tpu.ops import imaging as ref_imaging
    from mcray_tpu.ops import texture as ref_texture

    scene = {k: jnp.asarray(v) for k, v in pack.trace_tables().items()}
    volume = ref_texture.make_texture_volume(jax.random.PRNGKey(seed ^ 0x5CA77E7), ref_cfg)
    maps = tuple(jnp.asarray(m) for m in ref_imaging.scan_conversion_maps(ref_cfg))
    pose = (jnp.asarray(pack.transducer_position), jnp.asarray(pack.transducer_angles))

    def render(key, materials, position=None, angles=None):
        pos = pose[0] if position is None else jnp.asarray(position)
        ang = pose[1] if angles is None else jnp.asarray(angles)
        out = ref_sim.render(key, materials, pos, ang, scene, jnp.asarray(pack.spacing),
                             jnp.int32(pack.starting_material), volume, maps, ref_cfg)
        # the port clamps the B-mode at 0, as the reference's kernel path does
        return jnp.maximum(out["bmode"], 0.0)

    return render, np.asarray(volume["seeds"])


def port_render_fn(port_cfg, pack, seeds, draws):
    """``render(frame, materials, position=None, angles=None) -> bmode``
    through the port on the CPU from the reference's texture seeds and draws
    (``frame`` is ignored: fixed randomness), at the scene's pose unless one
    is given."""
    from mcray_tpu_torch.models import simulator
    from mcray_tpu_torch.ops import imaging
    from mcray_tpu_torch.ops.cuda.scanconv import scan_maps
    from mcray_tpu_torch.utils.convert import from_reference

    state = from_reference(pack, pack.materials, seeds, draws, device="cpu")
    maps = scan_maps(*imaging.scan_conversion_maps(port_cfg), port_cfg.rf_rows, port_cfg.rf_cols)

    def render(frame, materials, position=None, angles=None):
        return simulator.render(
            state["draws"], state["seeds"], materials,
            state["position"] if position is None else position,
            state["angles"] if angles is None else angles,
            state["scene"], state["spacing"], state["starting_material"], maps, port_cfg)["bmode"]

    return render


def spawn_ranks(case: str, world: int, out_dir) -> list:
    """``world`` processes of ``tests/torch_shard_worker.py`` running
    ``case`` as the ranks of one gloo group on a free local port: started,
    not waited for (``collect_ranks``)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, SHARD_WORKER, case, str(rank), str(world), str(port),
                              str(out_dir)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, env=env, cwd=ROOT)
            for rank in range(world)]


def collect_ranks(procs, out_dir) -> list[dict]:
    """Each rank's arrays, once every rank exited 0 within the timeout (the
    ranks are killed either way)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SHARD_WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed (rc={p.returncode}):\n{out}"
    return [dict(np.load(os.path.join(out_dir, f"rank{rank}.npz"))) for rank in range(len(procs))]


def envelope_walk(col: np.ndarray) -> np.ndarray:
    """The reference C++ peak-lerp walk over one column, in float32, row by
    row: the loop that the scan form of ``imaging.envelope`` (both packages')
    stands for."""
    x = col.astype(np.float32).copy()
    rows = x.shape[0]
    if rows < 3:
        return x
    one = np.float32(1.0)
    prev_pos, prev_val, start = 0, x[0], 0   # before the first peak: the raw first row
    xm, xc = x[0], x[1]
    for i in range(1, rows - 1):
        xn = x[i + 1]
        if xm < xc and not xc < xn:
            next_val = np.abs(xc)
            denom = np.float32(max(i - prev_pos, 1))
            for j in range(start, i):
                alpha = np.float32(j - prev_pos) / denom
                x[j] = prev_val * (one - alpha) + next_val * alpha
            prev_pos, prev_val, start = i, next_val, i
        xm, xc = xc, xn
    return x
