"""K3's plain version against the reference's postproc.

``convolve_envelope_pallas(rf, cfg, interpret=True)`` runs the reference's
fused kernel on the CPU; ``imaging.envelope(imaging.convolve_psf(rf))`` is
the reference's jnp form, whose semantics K3 follows. Same taps, same
summation order, same closed-form envelope: rtol 1e-5, atol 1e-6.

On a sparse RF image the reference's two forms disagree with each other
(ROADMAP, reference-side defects): at a few cells where the jnp-convolved
column holds a plateau after a rise, the Pallas kernel's fused output
differs from ``imaging.envelope``. The port follows ``imaging.envelope``,
which documents the C++ peak walk it unrolls (``imaging.py:247-257``): a
peak fires at row i iff x[i-1] < x[i] >= x[i+1], so on a plateau at its
first row. The sparse case is therefore held against the jnp form, the
dense cases against both, and a hand-built plateau column pins the rule.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import both_configs, to_np, to_torch
from mcray_tpu.ops import imaging as ref_imaging
from mcray_tpu.ops.pallas.postproc import convolve_envelope_pallas
from mcray_tpu_torch.ops import imaging
from mcray_tpu_torch.ops.cuda import postproc


def _sparse_rf(rng, rows, cols):
    """Realistic sparse RF: mostly zeros and a few echoes (no-peak columns,
    tails after the last peak)."""
    rf = np.zeros((rows, cols), np.float32)
    n = rows * cols // 150
    rf[rng.integers(0, rows, n), rng.integers(0, cols, n)] = rng.standard_normal(n)
    return rf


@pytest.mark.parametrize(
    "shape", [(465, 64), (60, 128), (12, 16)], ids=["full-height", "short", "below-kernel-span"]
)
def test_postproc_plain_matches_pallas(rng, shape):
    ref_cfg, cfg = both_configs(small=False)
    rf = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(convolve_envelope_pallas(jnp.asarray(rf), ref_cfg, interpret=True))
    got = to_np(postproc.postproc_cuda(to_torch(rf), cfg))  # CPU tensor: the plain version
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_postproc_plain_matches_jnp(rng, sparse):
    ref_cfg, cfg = both_configs(small=False)
    rf = _sparse_rf(rng, 465, 48) if sparse else rng.standard_normal((465, 48)).astype(np.float32)
    conv = jax.jit(lambda x: ref_imaging.convolve_psf(x, ref_cfg))(jnp.asarray(rf))
    env = jax.jit(ref_imaging.envelope)(conv)
    got_conv = imaging.convolve_psf(to_torch(rf), cfg)
    np.testing.assert_allclose(to_np(got_conv), np.asarray(conv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        to_np(imaging.envelope(to_torch(np.asarray(conv)))), np.asarray(env), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        to_np(postproc.postproc_cuda(to_torch(rf), cfg)), np.asarray(env), rtol=1e-5, atol=1e-6)


def test_plateau_peak_follows_jnp_envelope():
    """Plateaus after a rise (2, 2 and 3, 3, 3): the peak is the plateau's
    first row, rows before the first peak lerp from the raw first row, and
    rows after the last peak keep their raw values."""
    ref_cfg, cfg = both_configs(small=False)
    col = np.array([0.0, 0.5, 2.0, 2.0, 1.0, 0.25, 3.0, 3.0, 3.0, 0.5, 0.1, 0.0], np.float32)
    rf = np.tile(col[:, None], (1, 4))  # below the PSF span: postproc is the envelope alone
    want = np.array([0.0, 1.0, 2.0, 2.25, 2.5, 2.75, 3.0, 3.0, 3.0, 0.5, 0.1, 0.0], np.float32)
    ref_env = np.asarray(ref_imaging.envelope(jnp.asarray(rf)))
    np.testing.assert_array_equal(ref_env[:, 0], want)
    np.testing.assert_array_equal(to_np(imaging.envelope(to_torch(rf))), ref_env)
    np.testing.assert_array_equal(to_np(postproc.postproc_cuda(to_torch(rf), cfg)), ref_env)
    # fed the plateau directly, the reference's Pallas kernel applies the same rule
    np.testing.assert_allclose(
        np.asarray(convolve_envelope_pallas(jnp.asarray(rf), ref_cfg, interpret=True)), ref_env,
        rtol=1e-6)


def test_unported_modes_raise():
    """The Hilbert envelope and the centered PSF are ported (values in
    ``tests/test_torch_imaging_modes.py``); an envelope mode that neither
    package has raises."""
    rf = to_torch(np.zeros((40, 20), np.float32))
    assert torch.equal(imaging.apply_envelope(rf, both_configs(envelope_mode="hilbert")[1]), rf)
    assert torch.equal(imaging.convolve_psf(rf, both_configs(centered_psf=True)[1]), rf)
    with pytest.raises(ValueError, match="envelope_mode"):
        imaging.apply_envelope(rf, dataclasses.replace(both_configs()[1], envelope_mode="walk"))
