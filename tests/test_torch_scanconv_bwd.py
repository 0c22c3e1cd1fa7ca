"""The scan conversion's backward (the formulas of K9) on the CPU.

The ``Function`` around K4 differentiates through ``scan_convert_bwd_plain``
on CPU tensors; it is held against ``jax.vjp`` of both reference forms: the
split/banded Pallas kernels (``scan_convert_banded(..., interpret=True,
precision="highest")``, whose backward runs the transposed banded kernels)
and the jnp gather ``imaging.scan_convert``. The transposed remap sums up to
a few dozen ``w * g`` terms per RF cell in another order: rtol 1e-5, atol
1e-5. K9's own data structure, the CSR inverse map, is summed on the CPU in
the kernel's order and held against the plain version (rtol 1e-6, atol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import both_configs, to_np, to_torch
from mcray_tpu.ops import imaging as ref_imaging
from mcray_tpu.ops.pallas.scanconv import pack_scan_maps_banded, scan_convert_banded
from mcray_tpu_torch.ops import imaging
from mcray_tpu_torch.ops.cuda import scanconv

PROBES = ["convex", "linear", "phased"]


def _setup(probe):
    ref_cfg, cfg = both_configs(probe_type=probe)
    maps = imaging.scan_conversion_maps(cfg)
    table = scanconv.pack_scan_maps(*maps, cfg.rf_rows, cfg.rf_cols)
    rng = np.random.default_rng(5)
    rf = rng.standard_normal((cfg.rf_rows, cfg.rf_cols)).astype(np.float32)
    g = rng.standard_normal((cfg.bmode_rows, cfg.bmode_cols)).astype(np.float32)
    return ref_cfg, cfg, maps, table, rf, g


@pytest.mark.parametrize("probe", PROBES)
def test_scan_convert_backward_matches_reference(probe):
    ref_cfg, cfg, maps, table, rf, g = _setup(probe)
    x = to_torch(rf).requires_grad_(True)
    port_maps = scanconv.scan_maps(*maps, cfg.rf_rows, cfg.rf_cols)  # CPU: plain versions
    out = scanconv.scan_convert_cuda(x, port_maps)
    (got,) = torch.autograd.grad(out, x, to_torch(g))

    _, vjp = jax.vjp(lambda r: ref_imaging.scan_convert(r, *map(jnp.asarray, maps)),
                     jnp.asarray(rf))
    np.testing.assert_allclose(to_np(got), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-5)
    tb, j_w, band_k, split = pack_scan_maps_banded(*maps, ref_cfg.rf_rows, ref_cfg.rf_cols)
    _, vjp = jax.vjp(lambda r: scan_convert_banded(
        r, jnp.asarray(tb), j_w, ref_cfg.bmode_cols, band_k=band_k, split=split,
        out_rows=ref_cfg.bmode_rows, interpret=True, precision="highest"), jnp.asarray(rf))
    np.testing.assert_allclose(to_np(got), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-5)
    assert np.abs(to_np(got)).max() > 0.5


@pytest.mark.parametrize("probe", PROBES)
def test_inverse_map_is_the_transposed_remap(probe):
    """``invert_scan_table``'s CSR lists, summed per RF cell in ascending
    pixel order as K9 sums them, give the plain backward; pixels ascend
    within a cell and no zero-weight or out-of-range tap is listed."""
    _, cfg, _, table, _, g = _setup(probe)
    row_ptr, pixel, weight = scanconv.invert_scan_table(table, cfg.rf_rows, cfg.rf_cols,
                                                        cfg.bmode_cols)
    n_cells = cfg.rf_rows * cfg.rf_cols
    assert row_ptr.dtype == pixel.dtype == np.int32 and weight.dtype == np.float32
    assert row_ptr.shape == (n_cells + 1,) and row_ptr[0] == 0 and row_ptr[-1] == pixel.size
    assert (np.diff(row_ptr) >= 0).all() and (weight != 0).all()
    assert pixel.min() >= 0 and pixel.max() < cfg.bmode_rows * cfg.bmode_cols
    cell = np.repeat(np.arange(n_cells), np.diff(row_ptr))
    same_cell = cell[1:] == cell[:-1]
    assert (np.diff(pixel.astype(np.int64))[same_cell] > 0).all()

    got = np.zeros(n_cells, np.float32)
    np.add.at(got, cell, weight * g.reshape(-1)[pixel])  # in list order, one cell at a time
    want = scanconv.scan_convert_bwd_plain(to_torch(g), to_torch(table), cfg.rf_rows, cfg.rf_cols)
    np.testing.assert_allclose(got.reshape(cfg.rf_rows, cfg.rf_cols), to_np(want),
                               rtol=1e-6, atol=1e-6)
    # every non-zero tap of the forward is listed once
    t = table[:, :, : cfg.bmode_cols]
    taps = sum(int(((wr * wc) != 0).sum()) for wr in (t[:, 1], t[:, 2]) for wc in (t[:, 4], t[:, 5]))
    assert pixel.size == taps


def test_scan_maps_hold_the_table_and_its_transpose():
    """``scan_maps`` builds the table K4 reads and the CSR lists K9 reads as
    one object, so a render that can run forward can run backward."""
    _, cfg, maps, table, _, _ = _setup("convex")
    built = scanconv.scan_maps(*maps, cfg.rf_rows, cfg.rf_cols)
    inverse = scanconv.invert_scan_table(table, cfg.rf_rows, cfg.rf_cols, cfg.bmode_cols)
    np.testing.assert_array_equal(to_np(built.table), table)
    for got, want in zip((built.row_ptr, built.pixel, built.weight), inverse):
        np.testing.assert_array_equal(to_np(got), want)
    assert (built.rf_rows, built.rf_cols, built.out_cols) == (cfg.rf_rows, cfg.rf_cols,
                                                              cfg.bmode_cols)
