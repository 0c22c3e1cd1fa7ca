"""K4's plain version against the reference's scan conversion.

Both reference forms: the split/banded Pallas kernels
(``scan_convert_banded(..., interpret=True, precision="highest")``, f32-exact
one-hot matmuls) and the jnp gather ``imaging.scan_convert``
(map_coordinates order 1). The port sums the same four taps in
map_coordinates' order: rtol 1e-5, atol 1e-6. K4 on the card reads the two
coordinate maps, not the packed table, and computes each pixel's weights
itself: its plain version from the maps must equal the table-driven one
bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import both_configs, to_np, to_torch
from mcray_tpu.ops import imaging as ref_imaging
from mcray_tpu.ops.pallas.scanconv import pack_scan_maps as ref_pack
from mcray_tpu.ops.pallas.scanconv import pack_scan_maps_banded, scan_convert_banded
from mcray_tpu_torch.ops import imaging
from mcray_tpu_torch.ops.cuda import scanconv


@pytest.mark.parametrize("probe", ["convex", "linear", "phased"])
def test_scan_convert_plain_matches_reference(rng, probe):
    ref_cfg, cfg = both_configs(small=probe != "convex", probe_type=probe)
    maps = imaging.scan_conversion_maps(cfg)
    ref_maps = ref_imaging.scan_conversion_maps(ref_cfg)
    for m, r in zip(maps, ref_maps):
        np.testing.assert_array_equal(m, r)
    table = scanconv.pack_scan_maps(*maps, cfg.rf_rows, cfg.rf_cols)
    np.testing.assert_array_equal(table, ref_pack(*maps, cfg.rf_rows, cfg.rf_cols))

    rf = rng.standard_normal((cfg.rf_rows, cfg.rf_cols)).astype(np.float32)
    got = to_np(scanconv.scan_convert_cuda(
        to_torch(rf), scanconv.scan_maps(*maps, cfg.rf_rows, cfg.rf_cols)))
    want_gather = np.asarray(ref_imaging.scan_convert(jnp.asarray(rf), *map(jnp.asarray, maps)))
    np.testing.assert_allclose(got, want_gather, rtol=1e-5, atol=1e-6)
    tb, j_w, band_k, split = pack_scan_maps_banded(*maps, cfg.rf_rows, cfg.rf_cols)
    want_banded = np.asarray(scan_convert_banded(
        jnp.asarray(rf), jnp.asarray(tb), j_w, cfg.bmode_cols, band_k=band_k, split=split,
        out_rows=cfg.bmode_rows, interpret=True, precision="highest",
    ))
    np.testing.assert_allclose(got, want_banded, rtol=1e-5, atol=1e-6)
    # the port's own map-driven gather is the same function
    np.testing.assert_allclose(
        to_np(imaging.scan_convert(to_torch(rf), *map(to_torch, maps))), got, rtol=1e-6, atol=1e-7
    )


def test_scan_convert_border_is_zero():
    _, cfg = both_configs(small=False)
    map_row, map_col = imaging.scan_conversion_maps(cfg)
    table = scanconv.pack_scan_maps(map_row, map_col, cfg.rf_rows, cfg.rf_cols)
    out = to_np(scanconv.scan_convert_plain(
        to_torch(np.ones((cfg.rf_rows, cfg.rf_cols), np.float32)), to_torch(table), cfg.bmode_cols))
    outside = (map_row < -1) | (map_row > cfg.rf_rows) | (map_col < -1) | (map_col > cfg.rf_cols)
    assert outside.any()
    np.testing.assert_array_equal(out[outside], 0.0)


@pytest.mark.parametrize("probe", ["convex", "linear", "phased"])
def test_scan_convert_from_coords_matches_the_table(rng, probe):
    """``scan_convert_coords_plain`` (floor, fraction and edge weights from
    ``ScanMaps.coords`` in f32, K4's computation) equals the table-driven
    ``scan_convert_plain`` bitwise, and the maps are the geometry's."""
    _, cfg = both_configs(small=probe != "convex", probe_type=probe)
    maps = imaging.scan_conversion_maps(cfg)
    built = scanconv.scan_maps(*maps, cfg.rf_rows, cfg.rf_cols)
    assert built.coords.dtype == torch.float32
    assert tuple(built.coords.shape) == (2, cfg.bmode_rows, cfg.bmode_cols)
    np.testing.assert_array_equal(to_np(built.coords), np.stack(maps))
    rf = to_torch(rng.standard_normal((cfg.rf_rows, cfg.rf_cols)).astype(np.float32))
    got = scanconv.scan_convert_coords_plain(rf, built.coords)
    want = scanconv.scan_convert_plain(rf, built.table, cfg.bmode_cols)
    assert torch.equal(got, want)
    # outside the fan (every weight 0) both read 0; inside, texture
    t = built.table[:, :, : cfg.bmode_cols]
    outside = ((t[:, 1] == 0) & (t[:, 2] == 0)) | ((t[:, 4] == 0) & (t[:, 5] == 0))
    assert not bool(got[outside].any()) and float(got[~outside].std()) > 0
    if probe != "linear":
        assert bool(outside.any())
