"""From the traced segments to the B-mode, in plain torch: the march of every
segment through the hashed scatterer field into the RF image (each RF pixel
sums the one march step of each of its column's segments that lands in its
row, segments in ascending order), the reference's forward-shifted separable
PSF convolution, the peak-lerp envelope, and the bilinear polar-to-Cartesian
scan conversion, clamped at 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .trace import MU0, MU1, SIGMA, fdiv, safe_norm, take_rows

MASK32 = 0xFFFFFFFF
BITSUM_SCALE = float(np.float32(1.0 / (4.0 + 1.0 / 12.0) ** 0.5))
REF_PI = 3.14159  # the acquisition's own value of pi for the PSF (src/psf.h:9)


def derived(p: dict) -> dict:
    """The acquisition's derived quantities."""
    axial_mm = 1.45 / p["transducer_frequency"]
    axial_um = int(axial_mm * 1000.0)
    window_us = int(p["ultrasound_depth_cm"] * 1e4 / p["speed_of_sound"])
    return {"axial_mm": axial_mm, "window_us": window_us,
            "rf_rows": (int(p["speed_of_sound"]) * window_us) // axial_um,
            "row_dt": axial_um / p["speed_of_sound"],
            "march_dt": axial_mm * 1000.0 / p["speed_of_sound"]}


# --- the scatterer field ---------------------------------------------------------

def _mul32(x, c: int):
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def hash_u32(x):
    x = x.long() & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _bitsum_normal(bits):
    x = bits >> 16
    x = x - ((x >> 1) & 0x5555)
    x = (x & 0x3333) + ((x >> 2) & 0x3333)
    x = (x + (x >> 4)) & 0x0F0F
    pc = ((x + (x >> 8)) & 0x1F).float()
    u = ((bits & 0xFFFF).float() + 0.5) * (1.0 / 65536.0)
    return (pc + u - 8.5) * BITSUM_SCALE


def scattering(seeds, density, mu, sigma, points, p):
    """Amplitude at ``points`` (..., 3): the nearest voxel (truncation,
    wrapped), ``noise * sigma + mu`` where the voxel's probability reaches
    the material's density, else 0."""
    res, size = p["resolution_um"] / 1000.0, p["volume_size"]

    def index(x):
        q = torch.trunc(fdiv(x, res)).long()
        return q & (size - 1) if size & (size - 1) == 0 else \
            torch.remainder(torch.remainder(q, size) + size, size)

    ix, iy, iz = (index(points[..., a]) for a in range(3))
    vid = ((ix.long() * size + iy.long()) * size + iz.long()) & MASK32
    noise = _bitsum_normal(hash_u32(vid ^ seeds[0]))
    prob = _bitsum_normal(hash_u32(vid ^ seeds[1]))
    return torch.where(prob >= density, noise * sigma + mu, 0.0)


# --- the march ---------------------------------------------------------------------

def march(segments, materials, seeds, p, n_cols: int, q=None):
    """The (rf_rows, n_cols) RF image of the (D, N) ``segments``."""
    q = q or (lambda x: x)
    g = derived(p)
    axres, dt, rdt = g["axial_mm"], g["march_dt"], g["row_dt"]
    d, n = segments["valid"].shape
    s = n // n_cols

    def per_col(x):  # (D, C*S) -> (S*D, C): segment s * D + d of column c
        return x.reshape(d, n_cols, s).permute(2, 0, 1).reshape(s * d, n_cols)

    seg_len = safe_norm(segments["to"] - segments["from"]) * 10.0
    steps = torch.floor(fdiv(seg_len, axres))
    t0 = fdiv(segments["distance"] * 1000.0, p["speed_of_sound"])
    ln_att = -segments["attenuation"] * axres * 0.01 * p["transducer_frequency"]
    rows = take_rows(materials, segments["media_id"])
    b_row = torch.floor(fdiv(t0 + dt * (steps - 1.0), rdt))
    b_ok = segments["valid"] & (steps >= 1.0) & (b_row >= 0) & (b_row < g["rf_rows"])
    b_row = torch.where(b_ok, b_row, -1.0)
    b_val = fdiv(segments["reflected"], float(p["samples_per_element"]))
    frm, dire = segments["from"], segments["direction"]
    f = {k: per_col(v) for k, v in {
        "fx": frm[..., 0], "fy": frm[..., 1], "fz": frm[..., 2],
        "dx": dire[..., 0], "dy": dire[..., 1], "dz": dire[..., 2],
        "t0": t0, "steps": steps, "ln_att": ln_att, "i0": segments["initial"],
        "mu0": rows[..., MU0], "mu1": rows[..., MU1], "sigma": rows[..., SIGMA],
        "b_row": b_row, "b_val": b_val, "valid": segments["valid"]}.items()}

    rows_f = torch.arange(g["rf_rows"], dtype=torch.float32, device=t0.device)[:, None]
    acc = torch.zeros((g["rf_rows"], n_cols), dtype=torch.float32, device=t0.device)
    for i in range(s * d):
        seg_t0, seg_steps = f["t0"][i], f["steps"][i]
        k_guess = torch.floor((rows_f - fdiv(seg_t0, rdt)) * (rdt / dt))
        k_sel = torch.zeros_like(k_guess)
        matched = torch.zeros_like(k_guess, dtype=torch.bool)
        for cand in (-1.0, 0.0, 1.0, 2.0):
            k = k_guess + cand
            t_k = seg_t0 + k * dt
            hit = ((torch.floor(fdiv(t_k, rdt)) == rows_f) & (k >= 0.0) & (k < seg_steps)
                   & (t_k < float(g["window_us"])))
            k_sel = torch.where(hit, k, k_sel)
            matched = matched | hit
        matched = matched & f["valid"][i]
        scale = k_sel * axres
        points = torch.stack([f["fx"][i] + scale * f["dx"][i], f["fy"][i] + scale * f["dy"][i],
                              f["fz"][i] + scale * f["dz"][i]], dim=-1)
        scat = scattering(seeds, f["mu1"][i], f["mu0"][i], f["sigma"][i], points, p)
        intens = f["i0"][i] * torch.exp(f["ln_att"][i] * k_sel)
        acc = acc + torch.where(matched, intens * scat, 0.0)
        acc = acc + torch.where(rows_f == f["b_row"][i], f["b_val"][i], 0.0)
    return q(acc)


# --- the PSF and the envelope ---------------------------------------------------

def psf_taps(p: dict):
    """The axial (Gaussian x cosine) and lateral (Gaussian) taps, in f32."""
    res = p["resolution_um"] / 1000.0

    def axis(size):
        i = np.arange(size, dtype=np.float32)
        return i * res - size * p["resolution_um"] / 1000.0 / 2.0

    x, y = axis(p["psf_axial_size"]), axis(p["psf_lateral_size"])
    ax = (np.exp(-0.5 * x * x / p["psf_var_x"])
          * np.cos(2.0 * REF_PI * p["transducer_frequency"] * x)).astype(np.float32)
    lat = np.exp(-0.5 * y * y / p["psf_var_y"]).astype(np.float32)
    return [float(v) for v in ax], [float(v) for v in lat]


def convolve(rf, p):
    """Forward-shifted separable convolution of each (rows, cols) image:
    rows [A, R-A) x cols [L/2, C-L) take the convolved value, every other
    cell keeps its raw one; taps summed k = 0..A-1, then 0..L-1."""
    ax, lat = psf_taps(p)
    rows, cols = rf.shape[-2:]
    a, l = len(ax), len(lat)
    if rows <= 2 * a or cols <= l + l // 2:
        return rf
    rv = rows - a + 1
    conv_ax = sum(rf[..., k:k + rv, :] * ax[k] for k in range(a))
    buf = torch.zeros_like(rf)
    buf[..., a:rows - a, :] = conv_ax[..., a:rows - a, :]
    cv = cols - l + 1
    conv_lat = sum(buf[..., k:k + cv] * lat[k] for k in range(l))
    out = rf.clone()
    out[..., a:rows - a, l // 2:cols - l] = conv_lat[..., a:rows - a, l // 2:cols - l]
    return out


def envelope(x):
    """The peak-lerp envelope along the rows of each column: a row lerps
    from the last peak at or before it (or the raw first value) to the next
    peak after it; rows past the last peak keep their raw values."""
    rows = x.shape[-2]
    rise = x[..., :-1, :] < x[..., 1:, :]
    peak = torch.zeros_like(x, dtype=torch.bool)
    peak[..., 1:-1, :] = rise[..., :-1, :] & ~rise[..., 1:, :]
    idx = torch.arange(rows, device=x.device)[:, None].expand_as(x)
    big = rows + 1
    absx = torch.abs(x)
    ppk = torch.cummax(torch.where(peak, idx, -1), dim=-2).values
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
    return torch.where(has_next, prev_val * (1.0 - alpha) + next_val * alpha, x)


# --- the scan conversion ----------------------------------------------------------

def scan_table(p: dict, device) -> torch.Tensor:
    """Per B-mode pixel (out_rows, 6, out_cols): [r0, w_r0, w_r1, c0, w_c0,
    w_c1] of the convex fan's polar-to-Cartesian map, taps outside the RF
    image weighted 0."""
    out_rows, out_cols = p["bmode_rows"], p["bmode_cols"]
    rf_rows, rf_cols = derived(p)["rf_rows"], p["transducer_elements"]
    radius_mm = p["transducer_radius_cm"] * 10.0
    total = math.radians(p["transducer_amplitude_deg"])
    depth_mm = derived(p)["window_us"] * p["speed_of_sound"] * 0.001
    ratio = (depth_mm + radius_mm - radius_mm * np.cos(total / 2.0)) / out_rows
    shift_y = radius_mm * np.cos(total / 2.0)
    i = np.arange(out_rows, dtype=np.float32)[:, None]
    j = np.arange(out_cols, dtype=np.float32)[None, :]
    fi = i + shift_y / ratio
    fj = j - out_cols / 2.0
    r = np.sqrt(fi * fi + fj * fj)
    angle = np.arctan2(fj, fi)
    map_row = ((r * ratio - radius_mm) / depth_mm * rf_rows).astype(np.float32)
    map_col = ((angle + total / 2.0) / total * rf_cols).astype(np.float32)
    r0, c0 = np.floor(map_row), np.floor(map_col)
    ar, ac = map_row - r0, map_col - c0

    def axis_w(i0, frac, n):
        w0 = (1.0 - frac) * ((i0 >= 0) & (i0 <= n - 1))
        w1 = frac * ((i0 + 1 >= 0) & (i0 + 1 <= n - 1))
        return w0.astype(np.float32), w1.astype(np.float32)

    w_r0, w_r1 = axis_w(r0, ar, rf_rows)
    w_c0, w_c1 = axis_w(c0, ac, rf_cols)
    table = np.stack([np.clip(r0, -1, rf_rows - 1), w_r0, w_r1, np.clip(c0, -1, rf_cols - 1),
                      w_c0, w_c1], axis=1).astype(np.float32)
    return torch.as_tensor(table, device=device)


def scan_convert(rf, table):
    """The four bilinear taps of each pixel, in map_coordinates' order; a tap
    outside the image reads 0."""
    rows, cols = rf.shape[-2:]
    flat = rf.reshape(rf.shape[:-2] + (rows * cols,))
    r0, w_r0, w_r1 = table[:, 0].long(), table[:, 1], table[:, 2]
    c0, w_c0, w_c1 = table[:, 3].long(), table[:, 4], table[:, 5]

    def tap(r, c):
        ok = (r >= 0) & (r < rows) & (c >= 0) & (c < cols)
        return torch.where(ok, flat[..., r.clamp(0, rows - 1) * cols + c.clamp(0, cols - 1)],
                           0.0)

    r1, c1 = r0 + 1, c0 + 1
    return ((w_r0 * w_c0) * tap(r0, c0) + (w_r0 * w_c1) * tap(r0, c1)
            + (w_r1 * w_c0) * tap(r1, c0) + (w_r1 * w_c1) * tap(r1, c1))


def fan_outside(table) -> torch.Tensor:
    """(out_rows, out_cols): the pixels that no RF sample reaches."""
    return ((table[:, 1] == 0) & (table[:, 2] == 0)) | ((table[:, 4] == 0) & (table[:, 5] == 0))
