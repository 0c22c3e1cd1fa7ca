"""mcray_tpu_torch.utils.rng (threefry2x32 in integer torch ops) against
jax.random, and the draws the port derives from a seed against the
reference's.

Keys, ``fold_in``, ``split``, random bits, ``uniform`` on [0, 1) and
``randint`` must equal JAX's bit for bit (JAX as the test run configures it:
the threefry2x32 implementation in partitionable mode). ``normal`` is
sqrt(2) erfinv(u) of a uniform that is equal bitwise, but XLA and ATen
evaluate ``erfinv`` differently. Measured over 2,000,000 draws against
float64: ATen's f32 ``erfinv`` stays within 4.6e-7 of the exact normal,
XLA's polynomial within 3.6e-7 for |z| < 2 but up to 2.2e-5 (5.8e-6
relative) off for |z| between 3 and 4. So the normal compares at rtol 1e-6,
atol 1e-6 for |z| < 2 and at NORMAL_RTOL = 1e-5 overall.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import both_configs, reference_draws, to_np
from mcray_tpu.ops import texture as ref_texture
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.ops import physics, texture
from mcray_tpu_torch.utils import rng

NORMAL_RTOL, NORMAL_ATOL = 1e-5, 1e-6
SEEDS = [0, 7, 2**31 - 1, 2**31 + 5, 2**32 + 9, -1, 5 ^ 0x5CA77E7]


def _raw(keys) -> np.ndarray:
    """A JAX key array (typed or raw uint32) as int64 words."""
    if jnp.issubdtype(keys.dtype, jax.dtypes.prng_key):
        keys = jax.random.key_data(keys)
    return np.asarray(keys).astype(np.int64)


def _keys(n=64):
    """(JAX keys (n,), port keys (n, 2)): fold_in(PRNGKey(42), 0..n-1)."""
    want = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.PRNGKey(42),
                                                   jnp.arange(n, dtype=jnp.uint32))
    return want, rng.fold_in(rng.prng_key(42), torch.arange(n))


def test_jax_runs_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches(seed):
    got = rng.prng_key(seed)
    assert got.dtype == torch.int64 and got.shape == (2,)
    np.testing.assert_array_equal(to_np(got), _raw(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("batched", [False, True], ids=["scalar", "batched"])
def test_fold_in_and_split_match(batched):
    if batched:
        want, got = _keys()
        np.testing.assert_array_equal(to_np(got), _raw(want))
        f_want = jax.vmap(jax.random.fold_in, (0, None))(want, 9)
        s_want = jax.vmap(lambda k: jax.random.split(k, 3))(want)
    else:
        want, got = jax.random.PRNGKey(3), rng.prng_key(3)
        f_want, s_want = jax.random.fold_in(want, 9), jax.random.split(want, 3)
    np.testing.assert_array_equal(to_np(rng.fold_in(got, 9)), _raw(f_want))
    np.testing.assert_array_equal(to_np(rng.split(got, 3)), _raw(s_want))
    assert rng.split(got).shape == got.shape[:-1] + (2, 2)
    # 2**32 - 1 as data, and a tensor of data against one key
    np.testing.assert_array_equal(to_np(rng.fold_in(rng.prng_key(3), 2**32 - 1)),
                                  _raw(jax.random.fold_in(jax.random.PRNGKey(3), 2**32 - 1)))


@pytest.mark.parametrize("batched", [False, True], ids=["scalar", "batched"])
def test_bits_uniform_and_randint_match_bitwise(batched):
    if batched:
        want, got = _keys()
        bits = jax.vmap(lambda k: jax.random.bits(k, (5,)))(want)
        unif = jax.vmap(jax.random.uniform)(want)
        ints = jax.vmap(lambda k: jax.random.randint(k, (2,), 0, 2**31 - 1))(want)
    else:
        want, got = jax.random.PRNGKey(11), rng.prng_key(11)
        bits = jax.random.bits(want, (5,))
        unif = jax.random.uniform(want)
        ints = jax.random.randint(want, (2,), 0, 2**31 - 1)
    np.testing.assert_array_equal(to_np(rng.random_bits(got, (5,))),
                                  np.asarray(bits).astype(np.int64))
    u = rng.uniform(got)
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(to_np(u), np.asarray(unif))
    np.testing.assert_array_equal(to_np(rng.randint(got, (2,), 0, 2**31 - 1)), np.asarray(ints))


@pytest.mark.parametrize("bounds", [(0, 10), (-5, 70000), (3, 3), (-2**31, 2**31 - 1)])
def test_randint_ranges_match(bounds):
    want = jax.random.randint(jax.random.PRNGKey(2), (4, 50), *bounds)
    got = rng.randint(rng.prng_key(2), (4, 50), *bounds)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


def test_shaped_draws_match():
    want_key, key = jax.random.PRNGKey(8), rng.prng_key(8)
    np.testing.assert_array_equal(to_np(rng.uniform(key, (3, 7))),
                                  np.asarray(jax.random.uniform(want_key, (3, 7))))
    np.testing.assert_array_equal(to_np(rng.random_bits(key, (2, 3, 4))),
                                  np.asarray(jax.random.bits(want_key, (2, 3, 4))).astype(np.int64))
    np.testing.assert_allclose(to_np(rng.normal(key, (1000,))),
                               np.asarray(jax.random.normal(want_key, (1000,))),
                               rtol=NORMAL_RTOL, atol=NORMAL_ATOL)


def test_normal_matches_to_erfinv_rounding():
    want, got = _keys(2000)
    a, b = np.asarray(jax.vmap(jax.random.normal)(want)), to_np(rng.normal(got))
    np.testing.assert_allclose(b, a, rtol=NORMAL_RTOL, atol=NORMAL_ATOL)
    centre = np.abs(a) < 2.0
    np.testing.assert_allclose(b[centre], a[centre], rtol=1e-6, atol=1e-6)
    assert abs(b.mean()) < 0.1 and abs(b.std() - 1.0) < 0.05 and np.isfinite(b).all()


@pytest.mark.parametrize("seed", [0, 5])
def test_draw_bounce_randoms_match_reference(seed):
    """The five fields of one frame from the seed alone, through the
    Simulator's key chain (fold_in(key, 0), then the global path id)."""
    _, cfg = both_configs(transducer_elements=16, samples_per_element=3)
    n = cfg.transducer_elements * cfg.samples_per_element
    want = reference_draws(seed, n, cfg.max_depth)
    key = rng.prng_key(seed)
    path_keys = rng.fold_in(rng.fold_in(key, 0), torch.arange(n))
    got = physics.draw_bounce_randoms(path_keys, cfg.max_depth)
    assert set(got) == set(want)
    for name, v in got.items():
        assert v.shape == (cfg.max_depth, n) and v.dtype == torch.float32
        if name == "q_normal":
            np.testing.assert_allclose(to_np(v), want[name], rtol=NORMAL_RTOL, atol=NORMAL_ATOL)
        else:
            np.testing.assert_array_equal(to_np(v), want[name], err_msg=name)


@pytest.mark.parametrize("seed", [0, 3, 2**31])
def test_texture_seeds_match_reference(seed, sphere_pack):
    ref_cfg, cfg = both_configs()
    want = np.asarray(ref_texture.make_texture_volume(jax.random.PRNGKey(seed ^ 0x5CA77E7),
                                                      ref_cfg)["seeds"])
    got = texture.make_texture_volume(rng.prng_key(seed ^ 0x5CA77E7), cfg)["seeds"]
    assert got.dtype == torch.int64 and got.shape == (2,)
    np.testing.assert_array_equal(to_np(got), want.astype(np.int64))


def test_simulator_derives_the_reference_randomness(sphere_pack):
    """``Simulator(seed=s).seeds`` and ``Simulator.draws(frame seed)`` (from
    an int or from its key) are the reference's for those seeds."""
    pack, _ = sphere_pack
    ref_cfg, cfg = both_configs(transducer_elements=16, samples_per_element=2)
    sim = Simulator(pack, cfg, device="cpu", seed=4)
    want = ref_texture.make_texture_volume(jax.random.PRNGKey(4 ^ 0x5CA77E7), ref_cfg)["seeds"]
    np.testing.assert_array_equal(to_np(sim.seeds), np.asarray(want).astype(np.int64))
    n = cfg.transducer_elements * cfg.samples_per_element
    want = reference_draws(9, n, cfg.max_depth)
    for got in (sim.draws(9), sim.draws(rng.prng_key(9))):
        for name in ("angle_u", "axis_u", "radius_u", "roulette_u"):
            np.testing.assert_array_equal(to_np(got[name]), want[name], err_msg=name)
        np.testing.assert_allclose(to_np(got["q_normal"]), want["q_normal"],
                                   rtol=NORMAL_RTOL, atol=NORMAL_ATOL)
