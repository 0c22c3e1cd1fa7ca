"""K2: output-stationary segment march into the RF image (``csrc/march.cu``).

Replaces ``mcray_tpu/ops/pallas/march.py:_march_kernel`` (op ``_march_op``,
wrapper ``march_and_accumulate_pallas``). Each RF pixel (row r, column c)
asks every segment of its own column which march step lands in row r: the
march time step exceeds the RF row pitch, so at most one step does, and
``_match_rows`` solves for it and verifies it with the forward binning
``floor((t0 + k*dt)/rdt) == r``. The pixel then evaluates the hashed
scatterer field at that step, adds ``I0 * exp(ln_att * k) * scat``, and
adds the segment's boundary echo if it lands in row r. No scatter, no
atomics: one fixed accumulation order (ascending segment) per pixel.

On the card: one thread per RF pixel, the column index fastest in a warp
so the (SD, 16, C_pad) SoA reads coalesce; each thread loops over its
column's SD segments. The work is integer hashing plus a few f32 ops per
(pixel, segment) pair, with the (SD, 16, C_pad) SoA small enough to be
served from L2, so the kernel is bound by instruction issue. ``-fmad=false`` keeps the row
match identical to the plain version. The reference's per-tile span lists
(``_touch_tables``) are an optimisation for later: without them every
pixel visits every segment of its column, which changes no output.

Kernel modes: the CUDA kernel computes the default field only — bitsum
normals, nearest voxel, hard gate, power-of-two volume. Other modes raise
NotImplementedError for CUDA tensors; the plain version computes them all.
"""

from __future__ import annotations

import ctypes

import torch

from ...config import SimConfig
from .. import texture
from ..texture import fdiv
from . import _build

# Segment SoA field indices (layout (SD, F, C)), as in the reference
F_FROM_X, F_FROM_Y, F_FROM_Z, F_DIR_X, F_DIR_Y, F_DIR_Z, F_T0, F_STEPS, \
    F_LN_ATT, F_I0, F_MU0, F_MU1, F_SIGMA, F_B_ROW, F_B_VAL, F_VALID = range(16)
N_FIELDS = 16
TILE_C = 128

#: kernel launches since the last reset (one per call on a CUDA tensor)
launches = 0


def pack_segments(segments, materials, cfg: SimConfig, n_cols: int) -> torch.Tensor:
    """Regroup the (D, N) segment tensor into the kernel's (SD, 16, C_pad)
    SoA: paths are column-major (path = c * S + s), segment index
    sd = s * D + d, and C is padded to a multiple of 128 with invalid
    columns — the reference's ``pack_segments`` layout, field by field."""
    from ...models.simulator import segment_march_quantities

    d, n = segments["valid"].shape
    s = cfg.samples_per_element
    c = n_cols

    def per_col(x):  # (D, C*S) -> (C, S*D)
        return x.reshape(d, c, s).permute(1, 2, 0).reshape(c, s * d)

    steps, t0, ln_att, mu0, mu1, sigma = segment_march_quantities(segments, materials, cfg)
    b_row = torch.floor(fdiv(t0 + cfg.march_dt_us * (steps - 1.0), cfg.rf_row_dt_us))
    b_ok = segments["valid"] & (steps >= 1.0) & (b_row >= 0) & (b_row < cfg.rf_rows)
    b_row = torch.where(b_ok, b_row, -1.0)
    b_val = fdiv(segments["reflected"], float(s))
    frm, dire = segments["from"], segments["direction"]
    fields = [
        frm[..., 0], frm[..., 1], frm[..., 2],
        dire[..., 0], dire[..., 1], dire[..., 2],
        t0, steps, ln_att, segments["initial"],
        mu0, mu1, sigma, b_row, b_val,
        segments["valid"].float(),
    ]
    soa = torch.stack([per_col(f) for f in fields], dim=0).permute(2, 0, 1)  # (SD, F, C)
    pad = (-c) % TILE_C
    return torch.nn.functional.pad(soa, (0, pad)).contiguous()


def _match_rows(rows_f, t0, steps, valid, cfg: SimConfig):
    """Which march step (if any) of a segment lands in each row: the exact
    inverse of the forward binning floor(t_k / rdt). Returns (matched,
    k_sel); four candidates around the float guess cover its rounding."""
    dt = cfg.march_dt_us
    rdt = cfg.rf_row_dt_us
    k_guess = torch.floor((rows_f - fdiv(t0, rdt)) * (rdt / dt))
    k_sel = torch.zeros_like(k_guess)
    matched = torch.zeros_like(k_guess, dtype=torch.bool)
    for cand in (-1.0, 0.0, 1.0, 2.0):
        k = k_guess + cand
        t_k = t0 + k * dt
        hit = (
            (torch.floor(fdiv(t_k, rdt)) == rows_f)
            & (k >= 0.0)
            & (k < steps)
            & (t_k < float(cfg.max_travel_time_us))
        )
        k_sel = torch.where(hit, k, k_sel)
        matched = matched | hit
    return matched & valid, k_sel


def march_plain(soa: torch.Tensor, seeds: torch.Tensor, cfg: SimConfig, n_cols: int) -> torch.Tensor:
    """Plain version: the same per-pixel loop over segments, one (rows, C)
    slab per segment, in ascending segment order. Supports every texture
    mode ``texture.get_scattering`` does. Returns (rf_rows, n_cols)."""
    rows_f = torch.arange(cfg.rf_rows, dtype=torch.float32, device=soa.device)[:, None]
    volume = {"seeds": seeds.to(soa.device)}
    acc = torch.zeros((cfg.rf_rows, soa.shape[2]), dtype=torch.float32, device=soa.device)
    for f in soa:  # (16, C_pad) per segment
        matched, k_sel = _match_rows(rows_f, f[F_T0], f[F_STEPS], f[F_VALID] > 0.5, cfg)
        scale = k_sel * cfg.axial_resolution_mm
        points = torch.stack(
            [f[F_FROM_X] + scale * f[F_DIR_X],
             f[F_FROM_Y] + scale * f[F_DIR_Y],
             f[F_FROM_Z] + scale * f[F_DIR_Z]],
            dim=-1,
        )
        scat = texture.get_scattering(volume, f[F_MU1], f[F_MU0], f[F_SIGMA], points, cfg)
        intens = f[F_I0] * torch.exp(f[F_LN_ATT] * k_sel)
        acc = acc + torch.where(matched, intens * scat, 0.0)
        acc = acc + torch.where(rows_f == f[F_B_ROW], f[F_B_VAL], 0.0)
    return acc[:, :n_cols]


def _check_kernel_modes(cfg: SimConfig) -> None:
    unsupported = []
    if cfg.scatter_rng != "bitsum":
        unsupported.append(f"scatter_rng={cfg.scatter_rng!r}")
    if cfg.trilinear_texture:
        unsupported.append("trilinear_texture")
    if cfg.soft_scattering:
        unsupported.append("soft_scattering")
    if cfg.volume_size & (cfg.volume_size - 1):
        unsupported.append(f"volume_size={cfg.volume_size} (not a power of two)")
    if unsupported:
        raise NotImplementedError(
            "the CUDA march kernel computes bitsum + nearest + hard gate only; "
            "not ported yet: " + ", ".join(unsupported)
        )


def march_cuda(soa: torch.Tensor, seeds: torch.Tensor, cfg: SimConfig, n_cols: int) -> torch.Tensor:
    """RF image (rf_rows, n_cols) from the packed SoA: the CUDA kernel for a
    CUDA ``soa``, the plain version for a CPU one. ``seeds`` is the (2,)
    texture seed tensor (read on the host)."""
    global launches
    if soa.device.type == "cpu":
        return march_plain(soa, seeds, cfg, n_cols)
    sd, _, c_pad = soa.shape
    _build.require(soa, "soa", torch.float32, (sd, N_FIELDS, c_pad))
    if not n_cols <= c_pad:
        raise ValueError(f"n_cols={n_cols} exceeds the SoA width {c_pad}")
    _check_kernel_modes(cfg)
    seed0, seed1 = (int(v) & 0xFFFFFFFF for v in seeds.tolist())
    out = torch.empty((cfg.rf_rows, n_cols), dtype=torch.float32, device=soa.device)
    f32 = ctypes.c_float
    code = _build.library().mcray_march(
        soa.data_ptr(), sd, c_pad, n_cols, cfg.rf_rows, seed0, seed1,
        f32(cfg.rf_row_dt_us), f32(cfg.march_dt_us), f32(cfg.rf_row_dt_us / cfg.march_dt_us),
        f32(float(cfg.max_travel_time_us)), f32(cfg.axial_resolution_mm),
        f32(cfg.resolution_um / 1000.0), cfg.volume_size, f32(texture.BITSUM_SCALE),
        out.data_ptr(), _build.stream_of(soa),
    )
    _build.check(code, "mcray_march")
    launches += 1
    return out
