"""RF image pipeline: echo accumulation, PSF convolution, envelope, scan conversion.

Port of ``mcray_tpu/ops/imaging.py`` (reference src/rfimage.h) in plain torch:
- ``accumulate_echoes``: the per-echo ``+=`` of add_echo as an
  ``index_put_`` scatter-add; ``accumulate_echoes_soft`` its two-row
  relaxation (``cfg.soft_row_binning``);
- ``convolve_psf``: the reference-exact uncentered separable convolution,
  raw values kept outside the write window, or the centered 'same'
  correlation (``cfg.centered_psf``); ``convolve_psf_sharded`` and
  ``convolve_psf_rows_sharded`` the uncentered one on a column- or
  row-sharded image, with a halo from the neighbouring ranks;
- ``envelope``: the closed form of the C++ peak-lerp walk, with the
  (index, value) scans done as index scans (cummax/cummin) plus a gather;
  ``envelope_hilbert`` the |analytic signal| by ``torch.fft``;
- ``scan_convert``: cv::remap(INTER_LINEAR, BORDER_CONSTANT) as an explicit
  4-tap gather — ``grid_sample`` is avoided because its coordinate
  normalisation adds a rounding that ``map_coordinates`` does not have;
- ``gaussian_blur``: the separable edge-padded blur of the pose-registration
  objective (``models/trainer.py:PoseFitter``).

These are the plain versions that the CUDA postproc and scan-conversion
kernels (``ops/cuda``) are held against.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..config import SimConfig
from . import psf as psf_mod
from .collectives import shift_blocks
from .texture import fdiv


def time_to_row(time_us: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """row = floor(t / (axial_res_um / c)) (src/rfimage.h:35)."""
    return torch.floor(fdiv(time_us, cfg.rf_row_dt_us)).int()


def accumulate_echoes(rows, cols, values, valid, cfg: SimConfig, n_cols: int | None = None):
    """Masked scatter-add into a fresh (rf_rows, n_cols) image."""
    ok = valid & (rows >= 0) & (rows < cfg.rf_rows)
    rf = torch.zeros((cfg.rf_rows, n_cols or cfg.rf_cols), dtype=torch.float32, device=values.device)
    index = (torch.where(ok, rows, 0).long(), torch.where(ok, cols, 0).long())
    return rf.index_put_(index, torch.where(ok, values, 0.0), accumulate=True)


def accumulate_echoes_soft(times_us, cols, values, valid, cfg: SimConfig,
                           n_cols: int | None = None):
    """Two-row relaxation of add_echo (``cfg.soft_row_binning``): an echo
    lands in rows floor(t/rdt) and floor(t/rdt) + 1 with weights 1 - frac
    and frac, so d(RF)/d(time) is a row difference instead of zero. The
    gradient rides frac only (the floor is detached, as the reference's
    ``stop_gradient``); an echo in the last row loses its frac share past
    the image, as in the reference."""
    rf_row = fdiv(times_us, cfg.rf_row_dt_us)
    r0f = torch.floor(rf_row)
    frac = rf_row - r0f.detach()
    r0 = r0f.int()
    return accumulate_echoes(
        torch.cat([r0, r0 + 1]), torch.cat([cols, cols]),
        torch.cat([values * (1.0 - frac), values * frac]), torch.cat([valid, valid]),
        cfg, n_cols,
    )


def convolve_psf(rf: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    ax = [float(v) for v in psf_mod.axial_kernel_np(cfg)]
    lat = [float(v) for v in psf_mod.lateral_kernel_np(cfg)]
    if cfg.centered_psf:
        return _convolve_centered(rf, ax, lat)
    return _convolve_reference(rf, ax, lat)


def _convolve_centered(rf: torch.Tensor, ax, lat) -> torch.Tensor:
    """Centered separable 'same' correlation with zero padding, the
    fixed-up variant of the reference's shifted kernels: axial taps summed
    k = 0..A-1, then lateral taps k = 0..L-1. Over the last two axes of
    (..., rows, cols): each leading index is an image of its own."""
    a, l = len(ax), len(lat)
    pa, pl = a // 2, l // 2
    rows, cols = rf.shape[-2:]
    padded = torch.nn.functional.pad(rf, (0, 0, pa, a - 1 - pa))
    axial = sum(padded[..., k : k + rows, :] * ax[k] for k in range(a))
    padded2 = torch.nn.functional.pad(axial, (pl, l - 1 - pl))
    return sum(padded2[..., k : k + cols] * lat[k] for k in range(l))


def _convolve_reference(rf: torch.Tensor, ax, lat) -> torch.Tensor:
    """Forward-shifted (uncentered) kernels: axial pass into a buffer for rows
    [A, R-A), lateral pass written back only for rows [A, R-A) x cols
    [L/2, C-L); every other cell keeps its raw value (src/rfimage.h:97-122).
    Taps are summed in the order k = 0..A-1, then 0..L-1. Over the last two
    axes of (..., rows, cols): each image's window is its own."""
    rows, cols = rf.shape[-2:]
    a, l = len(ax), len(lat)
    if rows <= 2 * a or cols <= l + l // 2:  # the reference's loops never run
        return rf
    rv = rows - a + 1
    conv_ax = sum(rf[..., k : k + rv, :] * ax[k] for k in range(a))
    buf = torch.zeros_like(rf)
    buf[..., a : rows - a, :] = conv_ax[..., a : rows - a, :]
    cv = cols - l + 1
    conv_lat = sum(buf[..., k : k + cv] * lat[k] for k in range(l))
    out = rf.clone()
    out[..., a : rows - a, l // 2 : cols - l] = conv_lat[..., a : rows - a, l // 2 : cols - l]
    return out


def require_uncentered_psf(cfg: SimConfig, name: str) -> None:
    """The halo convolutions compute the reference's forward-shifted kernels
    only; the reference's own apply them under ``centered_psf`` as well, and
    so part from ``convolve_psf`` there (``mcray_tpu/ops/imaging.py:91-96``
    against ``:130-227``): the port raises instead."""
    if cfg.centered_psf:
        raise ValueError(f"{name} computes the uncentered PSF only; cfg.centered_psf is set "
                         "(gather the image and use convolve_psf)")


def _window_mask(idx: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return (idx >= lo) & (idx < hi)


def convolve_psf_sharded(rf_local: torch.Tensor, cfg: SimConfig, group=None) -> torch.Tensor:
    """``convolve_psf`` of a column-sharded RF image: this rank holds the
    columns [rank * C_local, (rank + 1) * C_local) of ``group`` (``None``:
    the default group) and gets the same columns of the convolved image.

    The axial pass is column-local. The lateral pass reads up to l - 1
    columns to the right of each output column (the forward-shifted kernel,
    src/rfimage.h:116-118), so each rank takes an (R, l - 1) halo from the
    ranks after it, a block at a time (``collectives.shift_blocks``), over
    as many ranks as it takes where a shard is narrower than the halo; the
    last rank's halo wraps to rank 0, and feeds only cells outside the write
    window. Cells outside the reference's window (global cols [l//2, C-l),
    rows [a, R-a)) keep their raw values. Port of
    ``mcray_tpu/ops/imaging.py:130-172``; differentiable (the halo's
    gradient goes back to its owner). Raises ValueError under
    ``cfg.centered_psf``."""
    require_uncentered_psf(cfg, "convolve_psf_sharded")
    ax = [float(v) for v in psf_mod.axial_kernel_np(cfg)]
    lat = [float(v) for v in psf_mod.lateral_kernel_np(cfg)]
    rows, c_local = rf_local.shape
    a, l = len(ax), len(lat)
    n_shards, me = dist.get_world_size(group), dist.get_rank(group)
    c_global = c_local * n_shards
    if rows <= 2 * a or c_global <= l + l // 2:  # the reference's loops never run
        return rf_local
    rv = rows - a + 1
    conv_ax = sum(rf_local[k : k + rv, :] * ax[k] for k in range(a))
    buf = torch.zeros_like(rf_local)
    buf[a : rows - a] = conv_ax[a : rows - a]

    parts, block = [buf], buf[:, : min(c_local, l - 1)]
    for _ in range(-(-(l - 1) // c_local)):
        block = shift_blocks(block, group)
        parts.append(block)
    buf_ext = torch.cat(parts, dim=1)[:, : c_local + l - 1]
    conv_lat = sum(buf_ext[:, k : k + c_local] * lat[k] for k in range(l))

    col = me * c_local + torch.arange(c_local, device=rf_local.device)
    row = torch.arange(rows, device=rf_local.device)
    write = (_window_mask(row, a, rows - a)[:, None]
             & _window_mask(col, l // 2, c_global - l)[None, :])
    return torch.where(write, conv_lat, rf_local)


def convolve_psf_rows_sharded(rf_local: torch.Tensor, cfg: SimConfig, group=None) -> torch.Tensor:
    """``convolve_psf`` of a row-sharded (time-sharded) RF image: this rank
    holds the rows [rank * R_local, (rank + 1) * R_local) of ``group``.

    Here the axial pass crosses shards: the forward-shifted 7-tap kernel
    reads rows [r, r + a) (src/rfimage.h:102-104), so each rank takes an
    (a - 1, C) halo from the ranks after it, over several where a shard is
    shorter than the halo (the last rank's wraps to rank 0 and feeds only
    rows the write mask drops). The lateral pass and the write window are
    then row-local, and the lateral pass reads a buffer that is zero outside
    the axial row window, as in ``_convolve_reference``. Port of
    ``mcray_tpu/ops/imaging.py:175-227``; differentiable. Raises ValueError
    under ``cfg.centered_psf``."""
    require_uncentered_psf(cfg, "convolve_psf_rows_sharded")
    ax = [float(v) for v in psf_mod.axial_kernel_np(cfg)]
    lat = [float(v) for v in psf_mod.lateral_kernel_np(cfg)]
    r_local, cols = rf_local.shape
    a, l = len(ax), len(lat)
    n_shards, me = dist.get_world_size(group), dist.get_rank(group)
    r_global = r_local * n_shards
    if r_global <= 2 * a or cols <= l + l // 2:
        return rf_local

    parts, block = [rf_local], rf_local[: min(r_local, a - 1)]
    for _ in range(-(-(a - 1) // r_local)):
        block = shift_blocks(block, group)
        parts.append(block)
    ext = torch.cat(parts, dim=0)[: r_local + a - 1]
    conv_ax = sum(ext[k : k + r_local, :] * ax[k] for k in range(a))

    row_ok = _window_mask(me * r_local + torch.arange(r_local, device=rf_local.device),
                          a, r_global - a)
    buf = torch.where(row_ok[:, None], conv_ax, 0.0)
    cv = cols - l + 1
    conv_lat = sum(buf[:, k : k + cv] * lat[k] for k in range(l))
    conv_full = torch.nn.functional.pad(conv_lat, (0, cols - cv))
    col_ok = _window_mask(torch.arange(cols, device=rf_local.device), l // 2, cols - l)
    return torch.where(row_ok[:, None] & col_ok[None, :], conv_full, rf_local)


def envelope(rf: torch.Tensor) -> torch.Tensor:
    """Closed form of the reference's sequential peak-lerp walk over rows,
    per column of (..., rows, cols).

    A peak is at row i (1 <= i <= R-2) iff x[i-1] < x[i] and x[i] >= x[i+1].
    Row j lerps from the last peak at or before j (|x| there, or the raw
    x[0] before the first peak) to the first peak after j; rows after the
    last peak, and all rows of a column without peaks, keep their raw values.
    """
    rows = rf.shape[-2]
    x = rf
    rise = x[..., :-1, :] < x[..., 1:, :]
    peak = torch.zeros_like(x, dtype=torch.bool)
    peak[..., 1:-1, :] = rise[..., :-1, :] & ~rise[..., 1:, :]

    idx = torch.arange(rows, device=rf.device)[:, None].expand_as(x)
    big = rows + 1
    absx = torch.abs(x)

    # previous peak at or before j (or -1)
    ppk = torch.cummax(torch.where(peak, idx, -1), dim=-2).values
    # next peak strictly after j: reverse running min, shifted by one row
    m = torch.flip(torch.cummin(torch.flip(torch.where(peak, idx, big), [-2]), dim=-2).values,
                   [-2])
    npk = torch.cat([m[..., 1:, :], torch.full_like(m[..., :1, :], big)], dim=-2)

    prev_pos = torch.clamp(ppk, min=0)
    prev_val = torch.where(ppk < 0, x[..., 0:1, :], absx.gather(-2, prev_pos))
    has_next = npk < big
    npk_pos = torch.where(has_next, npk, 0)
    next_val = absx.gather(-2, npk_pos)
    denom = torch.clamp(npk_pos - prev_pos, min=1)
    alpha = (idx - prev_pos).float() / denom.float()
    lerped = prev_val * (1.0 - alpha) + next_val * alpha
    return torch.where(has_next, lerped, x)


def envelope_hilbert(rf: torch.Tensor) -> torch.Tensor:
    """Exact envelope (``cfg.envelope_mode == "hilbert"``): |analytic
    signal| along the row (time) axis of (..., rows, cols) by FFT — positive
    frequencies doubled, DC (and Nyquist for an even row count) kept,
    negative ones zeroed."""
    rows = rf.shape[-2]
    h = np.zeros((rows,), np.float32)
    h[0] = 1.0
    if rows % 2 == 0:
        h[rows // 2] = 1.0
        h[1 : rows // 2] = 2.0
    else:
        h[1 : (rows + 1) // 2] = 2.0
    filt = torch.from_numpy(h).to(rf.device)[:, None]
    # cuFFT along the rows may hand back another layout: the kernels downstream take row-major
    return torch.abs(torch.fft.ifft(torch.fft.fft(rf, dim=-2) * filt, dim=-2)).contiguous()


def apply_envelope(rf: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    if cfg.envelope_mode == "hilbert":
        return envelope_hilbert(rf)
    if cfg.envelope_mode != "reference":
        raise ValueError(f"SimConfig.envelope_mode={cfg.envelope_mode!r}; expected 'reference' "
                         "or 'hilbert'")
    return envelope(rf)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur with edge padding and ``radius = int(3 * sigma)``
    (``mcray_tpu/ops/imaging.py:399-413``) of each (rows, cols) image of
    (..., rows, cols): blurring the compounded B-mode keeps the macro anatomy
    and suppresses the speckle micro-structure. The taps are summed as the
    reference sums them: rows first, then columns, taps ascending."""
    radius = int(3 * sigma)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-0.5 * fdiv(x, sigma) ** 2)
    k = k / k.sum()
    rows, cols = img.shape[-2:]
    pad_r = torch.arange(-radius, rows + radius, device=img.device).clamp(0, rows - 1)
    padded = img[..., pad_r, :]
    out = sum(padded[..., i : i + rows, :] * k[i] for i in range(k.shape[0]))
    pad_c = torch.arange(-radius, cols + radius, device=img.device).clamp(0, cols - 1)
    padded = out[..., pad_c]
    return sum(padded[..., i : i + cols] * k[i] for i in range(k.shape[0]))


def log_compress(img: torch.Tensor) -> torch.Tensor:
    """The reference's commented-out log compression (src/rfimage.h:131-136),
    each (rows, cols) image of (..., rows, cols) by its own maximum (what the
    reference's ``vmap`` over frames computes)."""
    peak = torch.amax(img, dim=(-2, -1), keepdim=True)
    return torch.log10(img + 1.0) / torch.log10(peak + 1.0)


def scan_conversion_maps(cfg: SimConfig) -> tuple[np.ndarray, np.ndarray]:
    """Polar->Cartesian sample maps (reference create_mapping,
    src/rfimage.h:183-215): (map_row, map_col), each (bmode_rows,
    bmode_cols) float32 RF-image coordinates per output pixel. Linear probes
    get a plain bilinear resize; phased probes the radius->0 sector."""
    out_rows, out_cols = cfg.bmode_rows, cfg.bmode_cols
    if cfg.probe_type == "linear":
        i = np.arange(out_rows, dtype=np.float32)[:, None]
        j = np.arange(out_cols, dtype=np.float32)[None, :]
        map_row = np.broadcast_to(i / out_rows * cfg.rf_rows, (out_rows, out_cols))
        map_col = np.broadcast_to(j / out_cols * cfg.rf_cols, (out_rows, out_cols))
        return map_row.astype(np.float32).copy(), map_col.astype(np.float32).copy()
    radius_mm = 0.0 if cfg.probe_type == "phased" else cfg.transducer_radius_cm * 10.0
    total = cfg.transducer_amplitude_rad
    depth_mm = cfg.max_travel_time_us * cfg.speed_of_sound * 0.001

    ratio = (depth_mm + radius_mm - radius_mm * np.cos(total / 2.0)) / out_rows
    shift_y = radius_mm * np.cos(total / 2.0)
    half_width = out_cols / 2.0

    i = np.arange(out_rows, dtype=np.float32)[:, None]
    j = np.arange(out_cols, dtype=np.float32)[None, :]
    fi = i + shift_y / ratio
    fj = j - half_width
    r = np.sqrt(fi * fi + fj * fj)
    angle = np.arctan2(fj, fi)

    map_row = (r * ratio - radius_mm) / depth_mm * cfg.rf_rows
    map_col = (angle + total / 2.0) / total * cfg.rf_cols
    return map_row.astype(np.float32), map_col.astype(np.float32)


def bilinear_gather(rf, r0, w_r0, w_r1, c0, w_c0, w_c1) -> torch.Tensor:
    """Sum of the four bilinear taps around (r0, c0) with per-axis weights,
    in map_coordinates' order: (r0,c0), (r0,c0+1), (r0+1,c0), (r0+1,c0+1).
    A tap outside the image reads 0 (BORDER_CONSTANT). ``rf`` is (..., rows,
    cols): every image is read at the same taps, (..., *r0.shape) out."""
    rows, cols = rf.shape[-2:]
    flat = rf.reshape(rf.shape[:-2] + (rows * cols,))

    def tap(r, c):
        ok = (r >= 0) & (r < rows) & (c >= 0) & (c < cols)
        v = flat[..., r.clamp(0, rows - 1) * cols + c.clamp(0, cols - 1)]
        return torch.where(ok, v, 0.0)

    r1, c1 = r0 + 1, c0 + 1
    return (
        (w_r0 * w_c0) * tap(r0, c0)
        + (w_r0 * w_c1) * tap(r0, c1)
        + (w_r1 * w_c0) * tap(r1, c0)
        + (w_r1 * w_c1) * tap(r1, c1)
    )


def scan_convert(rf: torch.Tensor, map_row: torch.Tensor, map_col: torch.Tensor) -> torch.Tensor:
    """Bilinear gather with zero fill outside — the reference's
    ``map_coordinates(order=1, mode="constant", cval=0)``; ``rf`` may carry
    leading axes."""
    r0f, c0f = torch.floor(map_row), torch.floor(map_col)
    ar, ac = map_row - r0f, map_col - c0f
    return bilinear_gather(rf, r0f.long(), 1.0 - ar, ar, c0f.long(), 1.0 - ac, ac)
