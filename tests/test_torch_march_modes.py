"""The march kernels' remaining modes on the CPU: Box–Muller normals, a
volume size that is no power of two, and the "table" texture — K2's and
K8's plain versions against the reference's Pallas march op in interpret
mode (forward, and ``jax.vjp`` of it), the voxel wrap the kernels compute,
and the table against the procedural field.

Inputs: the packed SoA of a seeded 32-element x 2-path sphere frame of the
port and a cotangent from a numpy seed; both packages get the same arrays.

Tolerances, as ``tests/test_torch_march_bwd.py``: forward rtol 1e-4, atol
1e-5, in trilinear mode atol 5e-5 of the image's largest |value| (at 32
elements a few cells where the eight-corner weighted sums of several
segments cancel differ by ~1.1e-5 of it between the frameworks, in bitsum
mode too); backward per SoA field within 1e-4 (nearest) or 2e-3 (trilinear,
the reference's own kernel-vs-plain gradient test's bound,
``tests/test_grad_pallas.py:83``; measured up to 5.9e-4 at size 48) of the
field's largest reference entry; steps within an ulp of a row boundary
set aside (``_borderline``). Box–Muller goes through each framework's
``log``, ``sqrt``, ``cos`` and ``sin``, which may differ by an ulp: with the
hard gate a voxel whose ``prob`` lies that close to ``mu1`` can flip. Such
cells are counted and must stay under 0.1% of the image (the same bound
holds the entries of the gradient).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import SPHERE_SCENE, both_configs, to_np
from mcray_tpu.ops import texture as ref_texture
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.ops import texture
from mcray_tpu_torch.ops.cuda import march
from mcray_tpu_torch.scene.compile import load_and_compile
from mcray_tpu_torch.utils import rng
from test_torch_march_bwd import ZERO_FIELDS, _borderline, _field_errors, _reference

ELEMENTS, PATHS = 32, 2
MODES = {
    "boxmuller-nearest-hard": {"scatter_rng": "boxmuller"},
    "boxmuller-trilinear-soft": {"scatter_rng": "boxmuller", "trilinear_texture": True,
                                 "soft_scattering": True},
    "size48-nearest-hard": {"volume_size": 48},
    "size48-trilinear-soft": {"volume_size": 48, "trilinear_texture": True,
                              "soft_scattering": True},
}
FLIP_SHARE = 1e-3  # Box–Muller, hard gate: at most this share of cells may flip


@pytest.fixture(scope="module")
def frame():
    _, cfg = both_configs(transducer_elements=ELEMENTS, samples_per_element=PATHS)
    sim = Simulator(load_and_compile(SPHERE_SCENE), cfg, device="cpu", seed=3)
    soa = sim.render_frame(4)["soa"]
    g = np.random.default_rng(17).standard_normal((cfg.rf_rows, cfg.rf_cols)).astype(np.float32)
    return soa, sim.seeds, torch.from_numpy(g)


@pytest.mark.parametrize("mode", MODES)
def test_march_modes_match_reference(frame, mode):
    soa, seeds, g = frame
    ref_cfg, cfg = both_configs(transducer_elements=ELEMENTS, samples_per_element=PATHS,
                                **MODES[mode])
    want_rf, want_grad = _reference(ref_cfg, soa, seeds, g)
    x = soa.clone().requires_grad_(True)
    rf = march.march_cuda(x, seeds, cfg, cfg.rf_cols)  # CPU tensor: the plain versions
    (grad,) = torch.autograd.grad(rf, x, g)

    edge_cells, edge_entries = _borderline(soa, cfg)
    assert edge_cells.mean() < 0.01 and edge_entries[:, : cfg.rf_cols].mean() < 0.05
    got, want = to_np(rf), want_rf[: cfg.rf_rows, : cfg.rf_cols]
    assert np.abs(want).max() > 0.1
    atol = 5e-5 * np.abs(want).max() if cfg.trilinear_texture else 1e-5
    close = np.isclose(got, want, rtol=1e-4, atol=atol) | edge_cells[:, : cfg.rf_cols]
    flips = int((~close).sum())
    if "boxmuller" in mode and "hard" in mode:
        assert flips <= FLIP_SHARE * close.size, f"{flips} cells flip"
    else:
        assert flips == 0, f"{flips} cells differ"

    keep = ~edge_entries
    if flips:  # the (segment, column) entries of a flipped cell's column are set aside
        keep[:, np.unique(np.nonzero(~close)[1])] = False
        assert keep[:, : cfg.rf_cols].mean() > 0.9
    tol = 2e-3 if "trilinear" in mode else 1e-4
    for f, (err, scale) in enumerate(_field_errors(to_np(grad), want_grad, keep)):
        assert err <= tol * scale, f"field {f}: err {err}, max |reference| {scale}"
        if f in ZERO_FIELDS:
            assert scale == 0.0, f


@pytest.mark.parametrize("size", [48, 7, 256, 32])
def test_voxel_wrap_matches_jnp_mod(size):
    """The kernels' wrap, transcribed: C's truncating % twice, or one AND
    for a power of two, gives jnp.mod's double mod on every int, negative
    ones included, and so does the plain version's ``_wrap_mod``."""
    q = np.concatenate([np.arange(-3 * size - 5, 3 * size + 5),
                        np.random.default_rng(size).integers(-2**30, 2**30, 4000)]).astype(np.int32)
    want = np.asarray(jnp.mod(jnp.mod(jnp.asarray(q), size) + size, size))
    qt = torch.from_numpy(q)
    if size & (size - 1) == 0:
        kernel = qt & (size - 1)
    else:
        kernel = torch.fmod(torch.fmod(qt, size) + size, size)  # fmod truncates, as C's %
    np.testing.assert_array_equal(to_np(kernel), want)
    np.testing.assert_array_equal(to_np(texture._wrap_mod(qt.long(), size)), want)
    assert want.min() == 0 and want.max() == size - 1


@pytest.mark.parametrize("rng_mode", ["bitsum", "boxmuller"])
@pytest.mark.parametrize("size", [32, 48])
def test_table_equals_the_procedural_field(rng_mode, size):
    """The "table" volume is filled from the hash field: a gather from it
    equals the field bitwise, nearest and trilinear, negative points
    included; the tables equal the reference's (bitwise for bitsum)."""
    ref_cfg, cfg = both_configs(texture_mode="table", volume_size=size, scatter_rng=rng_mode)
    vol = texture.make_texture_volume(rng.prng_key(9), cfg)
    assert vol["noise"].shape == (size,) * 3
    ref_vol = ref_texture.make_texture_volume(jax.random.PRNGKey(9), ref_cfg)
    np.testing.assert_array_equal(to_np(vol["seeds"]), np.asarray(ref_vol["seeds"]).astype(np.int64))
    for name in ("noise", "prob"):
        if rng_mode == "bitsum":
            np.testing.assert_array_equal(to_np(vol[name]), np.asarray(ref_vol[name]))
        else:
            np.testing.assert_allclose(to_np(vol[name]), np.asarray(ref_vol[name]),
                                       rtol=1e-5, atol=1e-5)
    gen = np.random.default_rng(size)
    points = torch.from_numpy(gen.uniform(-40.0, 40.0, (3000, 3)).astype(np.float32))
    mu1, mu0, sigma = (torch.from_numpy(gen.uniform(lo, hi, 3000).astype(np.float32))
                       for lo, hi in ((-1.0, 1.0), (0.0, 1.0), (0.1, 1.0)))
    for trilinear in (False, True):
        for soft in (False, True):
            _, c = both_configs(texture_mode="table", volume_size=size, scatter_rng=rng_mode,
                                trilinear_texture=trilinear, soft_scattering=soft)
            table = texture.get_scattering(vol, mu1, mu0, sigma, points, c)
            field = texture.get_scattering({"seeds": vol["seeds"]}, mu1, mu0, sigma, points, c)
            assert torch.equal(table, field), (trilinear, soft)
            assert float(table.abs().max()) > 0
