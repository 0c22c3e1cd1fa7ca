"""The imaging modes the reference runs outside its kernels — the centered
PSF, the Hilbert envelope and the two-row echo binning
(``cfg.soft_row_binning``) — and the plain postproc on a tall image, on the
CPU against ``mcray_tpu.ops.imaging``: values, and gradients against
``jax.vjp``. Inputs from numpy seeds, the same arrays to both packages.

Tolerances: the centered PSF rtol 1e-6 / atol 1e-6 (the same taps summed in
the same order); the Hilbert envelope rtol 1e-4 / atol 1e-5 of the image's
largest value (two FFT libraries, pocketfft against XLA's ducc: measured
2.3e-7 of it), its gradient atol 5e-4 of the largest entry (|z|'s gradient
is z / |z|, ill-conditioned where the analytic signal nears 0: measured
up to 9.2e-5); the soft
binning rtol 1e-6 / atol 1e-7 (one product and one scatter-add per echo);
gradients at the same bounds relative to their largest entry.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import SPHERE_SCENE, both_configs, to_np
from mcray_tpu.ops import imaging as ref_imaging
from mcray_tpu.ops import psf as ref_psf
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.ops import imaging
from mcray_tpu_torch.ops.cuda import postproc
from mcray_tpu_torch.scene.compile import load_and_compile


def _image(rows: int, cols: int, seed: int) -> np.ndarray:
    gen = np.random.default_rng(seed)
    img = gen.standard_normal((rows, cols)).astype(np.float32)
    img[gen.random((rows, cols)) < 0.6] = 0.0  # sparse echoes, as a raw RF image
    return img


def _vjp_both(ref_fn, port_fn, x: np.ndarray, g: np.ndarray):
    """(ref value, ref grad, port value, port grad) of ``fn`` at ``x`` for ``g``."""
    want, vjp = jax.vjp(ref_fn, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port_fn(xt)
    (gt,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    return np.asarray(want), np.asarray(vjp(jnp.asarray(g))[0]), to_np(got), to_np(gt)


def _assert_close(got, want, rtol, atol_rel):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * np.abs(want).max())
    assert np.abs(want).max() > 0


@pytest.mark.parametrize("shape", [(120, 64), (465, 48)])
def test_centered_psf_matches_reference(shape):
    ref_cfg, cfg = both_configs(centered_psf=True)
    ax, lat = ref_psf.axial_kernel(ref_cfg), ref_psf.lateral_kernel(ref_cfg)
    x, g = _image(*shape, 1), _image(*shape, 2)
    want, want_g, got, got_g = _vjp_both(lambda r: ref_imaging._convolve_centered(r, ax, lat),
                                         lambda r: imaging.convolve_psf(r, cfg), x, g)
    _assert_close(got, want, 1e-6, 1e-6)
    _assert_close(got_g, want_g, 1e-6, 1e-6)


@pytest.mark.parametrize("shape", [(120, 16), (465, 24), (121, 8)])
def test_hilbert_envelope_matches_reference(shape):
    ref_cfg, cfg = both_configs(envelope_mode="hilbert")
    x, g = _image(*shape, 3), _image(*shape, 4)
    want, want_g, got, got_g = _vjp_both(ref_imaging.envelope_hilbert,
                                         lambda r: imaging.apply_envelope(r, cfg), x, g)
    _assert_close(got, want, 1e-4, 1e-5)
    _assert_close(got_g, want_g, 1e-4, 5e-4)


def test_soft_row_binning_matches_reference():
    """Echo times spread over the image (and past its last row), their
    values and the gradient in both."""
    ref_cfg, cfg = both_configs(soft_row_binning=True)
    gen = np.random.default_rng(5)
    n = 4000
    times = gen.uniform(-1.0, cfg.max_travel_time_us + 2.0, n).astype(np.float32)
    cols = gen.integers(0, cfg.rf_cols, n).astype(np.int32)
    values = gen.standard_normal(n).astype(np.float32)
    valid = gen.random(n) < 0.9
    g = gen.standard_normal((cfg.rf_rows, cfg.rf_cols)).astype(np.float32)

    def ref_fn(t, v):
        return ref_imaging.accumulate_echoes_soft(t, jnp.asarray(cols), v, jnp.asarray(valid),
                                                  ref_cfg)

    want, vjp = jax.vjp(ref_fn, jnp.asarray(times), jnp.asarray(values))
    want_gt, want_gv = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    t, v = (torch.from_numpy(a).requires_grad_(True) for a in (times, values))
    got = imaging.accumulate_echoes_soft(t, torch.from_numpy(cols), v, torch.from_numpy(valid), cfg)
    got_gt, got_gv = torch.autograd.grad(got, (t, v), torch.from_numpy(g))
    _assert_close(to_np(got), np.asarray(want), 1e-6, 1e-7)
    _assert_close(to_np(got_gv), want_gv, 1e-6, 1e-7)
    _assert_close(to_np(got_gt), want_gt, 1e-5, 1e-6)


@pytest.mark.parametrize("rows", [1200])
def test_plain_postproc_on_a_tall_image(rows):
    """The plain postproc (K3's plain version) at a height past the
    kernel's 992 rows of peak masks, against the reference's plain
    convolution and envelope."""
    ref_cfg, cfg = both_configs()
    x = _image(rows, 40, 6)
    # jitted (op by op the reference's associative scans take ~17 s here); XLA
    # then contracts the tap sums into FMAs: atol 1e-5 (measured 1.4e-6)
    ref = jax.jit(lambda r: ref_imaging.apply_envelope(ref_imaging.convolve_psf(r, ref_cfg), ref_cfg))
    want = np.asarray(ref(jnp.asarray(x)))
    got = to_np(postproc.postproc_cuda(torch.from_numpy(x), cfg))  # CPU tensor: the plain version
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("overrides", [
    {"centered_psf": True}, {"envelope_mode": "hilbert"}, {"soft_row_binning": True},
    {"texture_mode": "table"}, {"texture_mode": "table", "soft_row_binning": True},
], ids=["centered-psf", "hilbert", "soft-row-binning", "table", "table-soft-row-binning"])
def test_modes_render_a_frame(overrides):
    """Each mode renders a frame through ``Simulator`` (no mode raises), and
    a table frame equals the procedural frame of the same config bitwise:
    the kernel path evaluates the hash, the scatter march (soft row
    binning) gathers from the table."""
    _, cfg = both_configs(transducer_elements=32, samples_per_element=2, **overrides)
    pack = load_and_compile(SPHERE_SCENE)
    out = Simulator(pack, cfg, device="cpu", seed=2).render_frame(3)
    bmode = out["bmode"]
    assert bmode.shape == (cfg.bmode_rows, cfg.bmode_cols)
    assert bool(torch.isfinite(bmode).all()) and float(bmode.std()) > 0
    if "texture_mode" in overrides:
        rest = {k: v for k, v in overrides.items() if k != "texture_mode"}
        _, base = both_configs(transducer_elements=32, samples_per_element=2, **rest)
        plain = Simulator(pack, base, device="cpu", seed=2).render_frame(3)
        assert torch.equal(out["rf_raw"], plain["rf_raw"])
    if "soft_row_binning" in overrides:
        assert out["soa"] is None  # the scatter march, not the kernel
