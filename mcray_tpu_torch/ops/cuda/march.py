"""K2 and K8: the segment march into the RF image and its backward
(``csrc/march.cu``, ``csrc/march_bwd.cu``).

Replaces ``mcray_tpu/ops/pallas/march.py:_march_kernel`` (op ``_march_op``,
wrapper ``march_and_accumulate_pallas``). Each RF pixel (row r, column c)
asks the segments of its own column which march step lands in row r: the
march time step exceeds the RF row pitch, so at most one step does, and
``_match_rows`` solves for it and verifies it with the forward binning
``floor((t0 + k*dt)/rdt) == r``. The pixel then evaluates the hashed
scatterer field at that step, adds ``I0 * exp(ln_att * k) * scat``, and
adds the segment's boundary echo if it lands in row r. No scatter, no
atomics: one fixed accumulation order (ascending segment) per pixel.

On the card K2 gives each warp one column and 64 consecutive rows (two per
lane); the warp lists, 32 segments at a time with a ballot, the segments whose
conservative row span (the reference's ``_touch_tables``) or boundary-echo
row meets its rows, and visits only those, in ascending order. A skipped
segment would have added exactly +0.0, so the image is bitwise what
matching every (pixel, segment) pair gives, which is ``march_plain``'s
arithmetic; ``-fmad=false`` keeps the row match identical to it.

K8 replaces ``mcray_tpu/ops/pallas/march.py:_march_bwd_kernel``: the
gradient of every SoA field from the RF cotangent, by rematerialisation
(nothing is saved but the SoA). The reference accumulates per (column tile,
row tile) into a revisited output block; on the card the loop is
segment-stationary instead: a warp per (segment, column) walks the
segment's own march steps (lane j takes k = j, j + 32, ...), bins
each into its row with the forward's formula and guards, and the group's
twelve non-zero field sums are reduced by shuffles in one fixed order —
one writer per output element, no atomics. ``march_bwd_plain`` holds the
same hand-derived formulas on (rows, C) slabs per segment.

``march_cuda`` is a ``torch.autograd.Function`` over both: K2 / K8 for CUDA
tensors, ``march_plain`` / ``march_bwd_plain`` for CPU tensors, in forward
and in backward. Gradients then flow through ``pack_segments`` (plain
torch) into the material table and the traced segments.

Kernel modes: every mode of the reference's ``_scat_eval`` — bitsum or
Box–Muller normals, any volume size, the nearest or the 8-corner trilinear
lookup, the hard or the soft-sigmoid gate — and both texture modes: a
"table" volume is filled from the same hash (``texture.make_texture_volume``),
so the kernels evaluate the hash for it, as the reference's kernel does.
Box–Muller's ``logf``/``sqrtf``/``cosf``/``sinf`` are the CUDA library's
full-precision functions; the kernels are held to the plain version at a
stated tolerance there, with the hard gate's flips counted.
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


def pack_segments(segments, materials, cfg: SimConfig, n_cols: int) -> torch.Tensor:
    """Regroup the (D, N) segment tensor into the kernel's (SD, 16, C_pad)
    SoA: paths are column-major (path = c * S + s), segment index
    sd = s * D + d, and C is padded to a multiple of 128 with invalid
    columns — the reference's ``pack_segments`` layout, field by field.
    S is the paths per column in ``segments`` (``N / n_cols``: fewer than
    ``cfg.samples_per_element`` where the samples are sharded); a boundary
    echo is weighted by 1 / ``cfg.samples_per_element`` all the same."""
    from ...models.simulator import segment_march_quantities

    d, n = segments["valid"].shape
    c = n_cols
    s = n // c

    def per_col(x):  # (D, C*S) -> (C, S*D)
        return x.reshape(d, c, s).permute(1, 2, 0).reshape(c, s * d)

    steps, t0, ln_att, mu0, mu1, sigma = segment_march_quantities(segments, materials, cfg)
    b_row = torch.floor(fdiv(t0 + cfg.march_dt_us * (steps - 1.0), cfg.rf_row_dt_us))
    b_ok = segments["valid"] & (steps >= 1.0) & (b_row >= 0) & (b_row < cfg.rf_rows)
    b_row = torch.where(b_ok, b_row, -1.0)
    b_val = fdiv(segments["reflected"], float(cfg.samples_per_element))
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


def _scat_partials(volume, px, py, pz, mu0, mu1, sigma, cfg: SimConfig) -> dict:
    """``texture.get_scattering`` at the points (px, py, pz) together with
    its partial derivatives w.r.t. mu0, mu1, sigma and the point, derived by
    hand (the reference's ``_scat_eval(..., want_grads=True)``). The point
    partials are zero in nearest mode (floor and truncation have zero
    derivative almost everywhere), d_mu1 is zero with the hard gate."""
    res = cfg.resolution_um / 1000.0
    size = cfg.volume_size

    def fetch(ix, iy, iz):
        return texture.procedural_fields(ix, iy, iz, volume["seeds"], size, rng=cfg.scatter_rng)

    zero = torch.zeros_like(px)
    dn, dp = [zero, zero, zero], [zero, zero, zero]
    if cfg.trilinear_texture:
        f = [fdiv(p, res) - 0.5 for p in (px, py, pz)]
        i0 = [torch.floor(x) for x in f]
        w = [x - fl for x, fl in zip(f, i0)]
        i0 = [x.long() for x in i0]
        noise, prob = zero, zero
        for ox in (0, 1):
            for oy in (0, 1):
                for oz in (0, 1):
                    n_t, p_t = fetch(*(texture._wrap_mod(i + o, size)
                                       for i, o in zip(i0, (ox, oy, oz))))
                    wfx, wfy, wfz = (wa if o else 1.0 - wa for wa, o in zip(w, (ox, oy, oz)))
                    wt = wfx * wfy * wfz
                    noise = noise + n_t * wt
                    prob = prob + p_t * wt
                    sx, sy, sz = (1.0 if o else -1.0 for o in (ox, oy, oz))
                    dn = [dn[0] + n_t * sx * wfy * wfz, dn[1] + n_t * sy * wfx * wfz,
                          dn[2] + n_t * sz * wfx * wfy]
                    dp = [dp[0] + p_t * sx * wfy * wfz, dp[1] + p_t * sy * wfx * wfz,
                          dp[2] + p_t * sz * wfx * wfy]
    else:
        noise, prob = fetch(*(texture._wrap_index(p, res, size) for p in (px, py, pz)))

    value = noise * sigma + mu0
    if cfg.soft_scattering:
        gate = torch.sigmoid(fdiv(prob - mu1, cfg.soft_scattering_tau))
        dgate = fdiv(gate * (1.0 - gate), cfg.soft_scattering_tau)
    else:
        gate = (prob >= mu1).float()
        dgate = None
    out = {"scat": value * gate, "d_mu0": gate, "d_sigma": noise * gate,
           "d_mu1": -value * dgate if dgate is not None else zero,
           "d_px": zero, "d_py": zero, "d_pz": zero}
    if cfg.trilinear_texture:
        d_noise = sigma * gate
        for axis, name in enumerate(("d_px", "d_py", "d_pz")):
            g = d_noise * dn[axis]
            if dgate is not None:
                g = g + (value * dgate) * dp[axis]
            out[name] = fdiv(g, res)
    return out


def march_bwd_plain(soa: torch.Tensor, seeds: torch.Tensor, g: torch.Tensor,
                    cfg: SimConfig) -> torch.Tensor:
    """Plain version of the march backward: the (SD, 16, C_pad) gradient of
    ``soa`` from the RF cotangent ``g`` (rf_rows, n_cols), per segment on
    (rows, C) slabs with the forward's row match, by the hand-derived
    formulas the kernel sums. Twelve fields are non-zero; t0, steps, b_row
    and valid (piecewise-constant uses only) get zero."""
    c_pad = soa.shape[2]
    g = torch.nn.functional.pad(g, (0, c_pad - g.shape[1]))
    rows_f = torch.arange(cfg.rf_rows, dtype=torch.float32, device=soa.device)[:, None]
    volume = {"seeds": seeds.to(soa.device)}
    gout = torch.zeros_like(soa)
    for f, go in zip(soa, gout):
        matched, k_sel = _match_rows(rows_f, f[F_T0], f[F_STEPS], f[F_VALID] > 0.5, cfg)
        scale = k_sel * cfg.axial_resolution_mm
        s = _scat_partials(
            volume, f[F_FROM_X] + scale * f[F_DIR_X], f[F_FROM_Y] + scale * f[F_DIR_Y],
            f[F_FROM_Z] + scale * f[F_DIR_Z], f[F_MU0], f[F_MU1], f[F_SIGMA], cfg)
        decay = torch.exp(f[F_LN_ATT] * k_sel)
        gm = torch.where(matched, g, 0.0)
        gi = gm * (f[F_I0] * decay)  # the cotangent routed through intens * scat
        go[F_I0] = (gm * decay * s["scat"]).sum(dim=0)
        go[F_LN_ATT] = (gi * k_sel * s["scat"]).sum(dim=0)
        go[F_MU0] = (gi * s["d_mu0"]).sum(dim=0)
        go[F_MU1] = (gi * s["d_mu1"]).sum(dim=0)
        go[F_SIGMA] = (gi * s["d_sigma"]).sum(dim=0)
        for axis, name in enumerate(("d_px", "d_py", "d_pz")):
            gp = gi * s[name]
            go[F_FROM_X + axis] = gp.sum(dim=0)
            go[F_DIR_X + axis] = (gp * scale).sum(dim=0)
        go[F_B_VAL] = torch.where(rows_f == f[F_B_ROW], g, 0.0).sum(dim=0)
    return gout


def _kernel_args(soa: torch.Tensor, seeds: torch.Tensor, cfg: SimConfig, n_cols: int):
    """Check ``soa`` for the kernels and return (sd, c_pad, seed0, seed1)."""
    sd, _, c_pad = soa.shape
    _build.require(soa, "soa", torch.float32, (sd, N_FIELDS, c_pad))
    if not n_cols <= c_pad:
        raise ValueError(f"n_cols={n_cols} exceeds the SoA width {c_pad}")
    seed0, seed1 = (int(v) & 0xFFFFFFFF for v in seeds.tolist())
    return sd, c_pad, seed0, seed1


def _texture_args(cfg: SimConfig):
    f32 = ctypes.c_float
    return (f32(cfg.resolution_um / 1000.0), cfg.volume_size, f32(texture.BITSUM_SCALE),
            int(cfg.trilinear_texture), int(cfg.soft_scattering),
            int(cfg.scatter_rng == "boxmuller"), f32(cfg.soft_scattering_tau))


def march_forward(soa: torch.Tensor, seeds: torch.Tensor, cfg: SimConfig, n_cols: int) -> torch.Tensor:
    """K2 for a CUDA ``soa``, ``march_plain`` for a CPU one (no autograd)."""
    if soa.device.type == "cpu":
        return march_plain(soa, seeds, cfg, n_cols)
    sd, c_pad, seed0, seed1 = _kernel_args(soa, seeds, cfg, n_cols)
    out = torch.empty((cfg.rf_rows, n_cols), dtype=torch.float32, device=soa.device)
    f32 = ctypes.c_float
    _build.launch(
        "mcray_march", soa.data_ptr(), sd, c_pad, n_cols, cfg.rf_rows, seed0, seed1,
        f32(cfg.rf_row_dt_us), f32(cfg.march_dt_us), f32(cfg.rf_row_dt_us / cfg.march_dt_us),
        f32(float(cfg.max_travel_time_us)), f32(cfg.axial_resolution_mm),
        *_texture_args(cfg), out.data_ptr(), device=soa.device,
    )
    return out


def march_backward(soa: torch.Tensor, seeds: torch.Tensor, g: torch.Tensor,
                   cfg: SimConfig) -> torch.Tensor:
    """K8 for a CUDA ``soa``, ``march_bwd_plain`` for a CPU one: the SoA's
    gradient (SD, 16, C_pad) from the RF cotangent ``g`` (rf_rows, n_cols)."""
    if soa.device.type == "cpu":
        return march_bwd_plain(soa, seeds, g, cfg)
    n_cols = g.shape[1]
    sd, c_pad, seed0, seed1 = _kernel_args(soa, seeds, cfg, n_cols)
    _build.require(g, "g", torch.float32, (cfg.rf_rows, n_cols))
    gout = torch.empty_like(soa)
    f32 = ctypes.c_float
    _build.launch(
        "mcray_march_bwd",
        soa.data_ptr(), g.data_ptr(), sd, c_pad, n_cols, cfg.rf_rows, seed0, seed1,
        f32(cfg.rf_row_dt_us), f32(cfg.march_dt_us), f32(float(cfg.max_travel_time_us)),
        f32(cfg.axial_resolution_mm), *_texture_args(cfg), gout.data_ptr(), device=soa.device,
    )
    return gout


class _March(torch.autograd.Function):
    """The march with its hand-written backward (no saved intermediates
    beyond the SoA: the backward rematerialises the forward's terms)."""

    @staticmethod
    def forward(ctx, soa, seeds, cfg, n_cols):
        ctx.save_for_backward(soa, seeds)
        ctx.cfg = cfg
        return march_forward(soa, seeds, cfg, n_cols)

    @staticmethod
    def backward(ctx, g):
        soa, seeds = ctx.saved_tensors
        return march_backward(soa, seeds, g.contiguous(), ctx.cfg), None, None, None


def march_cuda(soa: torch.Tensor, seeds: torch.Tensor, cfg: SimConfig, n_cols: int) -> torch.Tensor:
    """RF image (rf_rows, n_cols) from the packed SoA, differentiable in
    ``soa``: the CUDA kernels (K2 forward, K8 backward) for a CUDA ``soa``,
    the plain versions for a CPU one. ``seeds`` is the (2,) texture seed
    tensor (read on the host)."""
    return _March.apply(soa, seeds, cfg, n_cols)
