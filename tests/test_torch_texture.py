"""mcray_tpu_torch.ops.texture against mcray_tpu.ops.texture.

The scatterer field is a pure function of the voxel index and two seeds, so
the hash bits and the bitsum normals must be equal; Box-Muller goes through
log/cos/sin, whose last-ulp rounding differs between XLA and torch
(rtol 1e-5). Lookups compare at rtol 1e-5, atol 1e-6 for the same reason.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import both_configs, to_np, to_torch
from mcray_tpu.ops import texture as ref
from mcray_tpu_torch.ops import texture
from mcray_tpu_torch.utils.rng import prng_key

SEEDS = np.array([123456789, 2**31 - 2], np.uint32)


@pytest.mark.parametrize("rng_mode", ["bitsum", "boxmuller"])
def test_procedural_fields_bits_match(rng, rng_mode):
    size = 256
    ix, iy, iz = (rng.integers(0, size, 4096).astype(np.int32) for _ in range(3))
    vid = ((ix.astype(np.uint32) * size + iy) * size + iz).astype(np.uint32)
    for seed in SEEDS:
        want = np.asarray(ref.hash_u32(jnp.asarray(vid ^ seed)))
        got = to_np(texture.hash_u32(to_torch(vid.astype(np.int64) ^ int(seed))))
        np.testing.assert_array_equal(got, want.astype(np.int64))

    want = [np.asarray(f) for f in ref.procedural_fields(
        jnp.asarray(ix), jnp.asarray(iy), jnp.asarray(iz), jnp.asarray(SEEDS), size, rng=rng_mode)]
    got = [to_np(f) for f in texture.procedural_fields(
        to_torch(ix), to_torch(iy), to_torch(iz), to_torch(SEEDS.astype(np.int64)), size,
        rng=rng_mode)]
    for g, w in zip(got, want):
        if rng_mode == "bitsum":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "overrides",
    [{}, {"scatter_rng": "boxmuller"}, {"trilinear_texture": True, "soft_scattering": True},
     {"volume_size": 24}],
    ids=["bitsum-nearest-hard", "boxmuller", "trilinear-soft", "non-pow2-size"],
)
def test_get_scattering_matches(rng, overrides):
    ref_cfg, cfg = both_configs(**overrides)
    n = 2048
    points = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    density, mu, sigma = (rng.uniform(-1, 1, n).astype(np.float32) for _ in range(3))
    want = np.asarray(ref.get_scattering(
        {"seeds": jnp.asarray(SEEDS)}, jnp.asarray(density), jnp.asarray(mu),
        jnp.asarray(sigma), jnp.asarray(points), ref_cfg))
    got = to_np(texture.get_scattering(
        {"seeds": to_torch(SEEDS.astype(np.int64))}, to_torch(density), to_torch(mu),
        to_torch(sigma), to_torch(points), cfg))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_make_texture_volume_seeds():
    _, cfg = both_configs()
    a = texture.make_texture_volume(prng_key(7), cfg)["seeds"]
    b = texture.make_texture_volume(prng_key(7), cfg)["seeds"]
    assert a.shape == (2,) and a.dtype == torch.int64
    assert torch.equal(a, b)
    assert ((a >= 0) & (a < 2**31 - 1)).all()
    assert not torch.equal(a, texture.make_texture_volume(prng_key(8), cfg)["seeds"])
    # "table" mode keeps the same seeds beside the tables filled from them
    table = texture.make_texture_volume(prng_key(7), both_configs(texture_mode="table")[1])
    assert torch.equal(table["seeds"], a)
    assert table["noise"].shape == table["prob"].shape == (cfg.volume_size,) * 3
