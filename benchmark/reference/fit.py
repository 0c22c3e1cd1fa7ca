"""The plain reference of a step of the material fit: from a material table,
the step's frame keys, the target, and Adam's moments and step count, to the
step's B-modes, its loss, its masked gradient and its update.

It follows the JAX package's description of the fit, read and not imported:
the soft scattering gate, ``value * sigmoid((prob - density) / tau)``, and
the trilinear scatterer lookup (eight hashed voxels around ``points / res -
0.5``, weighted by the products of the fractions), ``mcray_tpu/ops/texture.py:
160-190``; the trace with the ray's reach detached from the gradient
(``mcray_tpu/models/simulator.py:136-143``: it sets which triangle is hit,
and its f32 derivative is cancellation noise); the step of
``mcray_tpu/models/trainer.py:MaterialFitter``: the pixel MSE of the mean of
the frames against the target, the gradient in the material table masked to
the trained entries, one ``optax.adam`` update at its defaults (written out
here as its formulas), and the clamp of the trained entries at 1e-4.

Everything else is the frame's reference (``frame.py``, ``trace.py``,
``imaging.py``), reused as it is: the draws, the element layout, the bounce
physics, the listed closest hit, the PSF, the envelope and the scan
conversion. The gradient is autograd's through plain torch, in float32.

One departure changes which triangle a few rays hit: the listed walk takes
each packet's cluster list ``GROUP`` rays at a time, each group with its own
box test and its own stop (``trace.listed_walk``'s ``group``), as the
program's closest-hit kernel walks it, where the JAX kernel walks the whole
packet. The two part only on rays that graze a cluster's box, where either
triangle is a closest hit to the last ulp; the frame's reference keeps the
packet's walk, and ``sphere.chained`` shows the parting (``PERF.md`` §7). In a
fit's gradient one such path moves the masked gradient by up to 8% (its
derivatives through a refraction near the critical angle are large), more
than a stale gradient is off: on the same paths the program's gradient is
the reference's within 1e-5.

Departures that change no value: the closest
hit's walk runs without a gradient (its choice is discrete) and the winner's
t is recomputed from its triangle with one, as the simulator does; each
segment's march into the RF image is recomputed in the backward
(``torch.utils.checkpoint``), so the gradient of a batch of frames at the
published widths fits in the card's memory; and the refracted angle
``sqrt(refr_sq)`` has the derivative 0 where ``refr_sq`` is exactly 0 (a
grazing ray at a boundary of equal impedances, or at the critical angle),
where the description's is infinite and turns the material table to NaN, as
the program takes it (``ops/physics.py``). ``control=True`` holds every
float state between two steps in bfloat16, as the frame's reference does,
the gradient flowing through the same roundings.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import imaging, trace
from .frame import LISTED_TILE_R, Reference, to_bf16
from .imaging import MASK32, _bitsum_normal, derived, hash_u32
from .trace import (ATTENUATION, IMPEDANCE, MU0, MU1, SHININESS, SIGMA, SPECULARITY, THICKNESS,
                    dot3, fdiv, normalize, random_unit_vector, safe_norm, safe_pow, take_rows)

#: rays of a packet that walk its cluster list together (``trace.listed_walk``)
GROUP = 4
#: optax.adam's defaults
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
#: the positivity floor of the trained entries
CLAMP_MIN = 1e-4
#: the fields whose value the fit's reference computes, and the value each
#: must have; soft_scattering and trilinear_texture may take either
FIXED_FIELDS = (("probe_type", "convex"), ("texture_mode", "procedural"),
                ("scatter_rng", "bitsum"), ("envelope_mode", "reference"),
                ("centered_psf", False), ("log_compression", False),
                ("soft_row_binning", False), ("cull_time_window", True),
                ("bug_compat_material_transition", False))


class FitReference(Reference):
    """The frame reference of an acquisition that may set ``soft_scattering``
    and ``trilinear_texture``, with a gradient in the material table."""

    def __init__(self, acquisition: dict, scene_path: str, mesh_dir: str, texture_seed: int,
                 device):
        for field, value in FIXED_FIELDS:
            if acquisition.get(field, value) != value:
                raise ValueError(f"the fit's reference computes {field}={value!r} only")
        # float32 throughout: no matrix product of the card's may round to TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__({**acquisition, "soft_scattering": False, "trilinear_texture": False},
                         scene_path, mesh_dir, texture_seed, device)
        self.p = dict(acquisition)
        self.p.setdefault("soft_scattering", False)
        self.p.setdefault("trilinear_texture", False)

    def frames(self, materials: torch.Tensor, frame_keys: torch.Tensor,
               control: bool = False) -> dict:
        """The (B, H, W) ``bmode`` of the (B, 2) ``frame_keys`` at the scene's
        pose, differentiable in ``materials`` (M, 8), and its ``segments``."""
        q = to_bf16 if control else (lambda x: x)
        b = frame_keys.shape[0]
        tables = {**self.tables, "materials": materials}
        draws = trace.draws(frame_keys, self.p, self.device)
        if control:
            draws = {k: to_bf16(v) for k, v in draws.items()}
        segments = trace_paths(draws, tables, self.position.expand(b, 3),
                               self.angles.expand(b, 3), self.p, self.clusters, q)
        wide = march(segments, materials, self.seeds, self.p, b * self.p["transducer_elements"],
                     q)
        rf = wide.reshape(derived(self.p)["rf_rows"], b, -1).transpose(0, 1).contiguous()
        env = q(imaging.envelope(imaging.convolve(rf, self.p)))
        bmode = q(torch.clamp(imaging.scan_convert(env, self.scan_table), min=0.0))
        return {"bmode": bmode, "segments": segments}

    def step(self, materials: torch.Tensor, exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor,
             adam_step: int, frame_keys: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
             learning_rate: float, control: bool = False) -> dict:
        """One fit step from ``materials`` with Adam's moments after
        ``adam_step`` updates: ``bmode`` (the step's frames), ``segments``,
        ``loss``, ``grad`` (masked), ``update`` (the table after the step less
        ``materials``), ``exp_avg`` and ``exp_avg_sq`` after it."""
        table = materials.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            out = self.frames(table, frame_keys, control)
            bmode = out["bmode"]
            pred = bmode[0] if bmode.shape[0] == 1 else bmode.mean(dim=0)
            loss = torch.mean((pred - target) ** 2)
            (grad,) = torch.autograd.grad(loss, table)
        grad = grad * mask
        t = adam_step + 1
        m = BETA1 * exp_avg + (1.0 - BETA1) * grad
        v = BETA2 * exp_avg_sq + (1.0 - BETA2) * grad * grad
        m_hat = m / (1.0 - BETA1 ** t)
        v_hat = v / (1.0 - BETA2 ** t)
        after = materials - learning_rate * m_hat / (torch.sqrt(v_hat) + EPS)
        after = torch.where(mask > 0, torch.clamp(after, min=CLAMP_MIN), after)
        return {"bmode": bmode.detach(), "loss": loss.detach(), "grad": grad,
                "update": after - materials, "exp_avg": m, "exp_avg_sq": v,
                "segments": {k: x.detach() for k, x in out["segments"].items()}}


def closest_hit(origins, seg_vecs, clusters, tile_r: int, group=GROUP):
    """``trace.closest_hit`` with the walk outside autograd: the hit record of
    each segment's winning triangle, its t recomputed with a gradient in the
    segment."""
    n = origins.shape[0]
    with torch.no_grad():
        n_pad = (-n) % tile_r
        o, s = origins.detach(), seg_vecs.detach()
        if n_pad:
            o = torch.cat([o, o.new_full((n_pad, 3), 0.0)])
            s = torch.cat([s, s.new_zeros((n_pad, 3))])
        rays = torch.cat([o, s], dim=1).T.contiguous()
        counts, ids, keys = trace.packet_lists(o, s, clusters, tile_r)
        live = torch.abs(s).sum(dim=1) > 0.0
        t0 = torch.where(live, trace.NO_HIT_T, 0.0)
        best_t, best_slot = trace.listed_walk(rays, counts, ids, keys, t0,
                                              torch.zeros_like(t0, dtype=torch.int32), clusters,
                                              group)
    hit = live[:n] & (best_t[:n] < 1.5)
    rows = clusters.slot_all.index_select(0, torch.clamp(best_slot[:n],
                                                          max=clusters.n_slots - 1).long())
    v0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    t_hit, _ = trace.moller_trumbore(origins, seg_vecs, v0, e1, e2)
    t_hit = torch.where(hit, t_hit, trace.NO_HIT_T)
    face_n = normalize(trace.cross3(e1, e2), eps=1e-20)
    flip = dot3(face_n, seg_vecs) > 0.0
    return {"hit": hit, "point": origins + t_hit[:, None] * seg_vecs,
            "normal": torch.where(flip[:, None], -face_n, face_n),
            "mesh_id": torch.where(hit, rows[:, 9].int(), -1)}


def trace_paths(bd_all, tables, positions, angles, p, clusters, q):
    """``trace.trace`` with the ray's reach detached (the description's
    ``stop_gradient``) and ``closest_hit`` above: the (D, N) segments, with a
    gradient in the material table."""
    n_samples = p["samples_per_element"]
    freq, eps = p["transducer_frequency"], p["intensity_epsilon"]
    window_us = float(int(p["ultrasound_depth_cm"] * 1e4 / p["speed_of_sound"]))
    elem_pos, elem_dir = trace.element_layout(positions, angles, p)
    device = elem_pos.device
    elem_idx = torch.arange(elem_pos.shape[0], dtype=torch.int32,
                            device=device).repeat_interleave(n_samples)
    n = elem_idx.shape[0]
    materials, spacing = tables["materials"], tables["spacing"]
    mesh_in, mesh_out, mesh_vasc = tables["mesh_in"], tables["mesh_out"], tables["mesh_vasc"]
    thick_by_mesh = take_rows(materials, mesh_in)[:, THICKNESS]
    src = q(elem_pos.repeat_interleave(n_samples, dim=0))
    direction = q(elem_dir.repeat_interleave(n_samples, dim=0))
    media_id = torch.full((n,), tables["starting_material"], dtype=torch.int32, device=device)
    media_outside_id = torch.full((n,), -1, dtype=torch.int32, device=device)
    intensity = torch.full((n,), p["initial_intensity"] / n_samples, dtype=torch.float32,
                           device=device)
    distance_mm = torch.zeros((n,), dtype=torch.float32, device=device)
    alive = torch.ones((n,), dtype=torch.bool, device=device)
    segments = []
    for d in range(p["max_depth"]):
        bd = {k: v[d] for k, v in bd_all.items()}
        att = take_rows(materials[:, ATTENUATION], media_id)
        inten = torch.clamp(intensity, min=eps * 1e-3)
        r_length = (10.0 * torch.log(torch.full_like(inten, eps) / inten) / -att * freq).detach()
        origin = src + p["ray_start_offset"] * direction
        dest = src + fdiv(r_length[:, None], 100.0) * spacing * direction
        alive_col = alive[:, None]
        seg_vec = (dest - origin) * alive_col
        origin = torch.where(alive_col, origin, 1e9)
        hits = closest_hit(origin, seg_vec, clusters, LISTED_TILE_R)
        hit = hits["hit"] & alive
        thick = take_rows(thick_by_mesh, hits["mesh_id"].clamp(min=0))
        qn = torch.abs(bd["q_normal"] * thick)
        inside_point = hits["point"] + qn[:, None] * direction
        dist_mm = safe_norm(torch.abs(src - inside_point) * spacing) * 10.0
        travelled = intensity * torch.exp(-att * dist_mm * 0.01 * freq)
        hb = hit_boundary(direction, hits["point"], hits["normal"], travelled, media_id,
                          media_outside_id, hits["mesh_id"], materials, mesh_in, mesh_out,
                          mesh_vasc, eps, bd)
        miss = alive & ~hits["hit"]
        segments.append({
            "from": src, "to": q(torch.where(hit[:, None], inside_point, dest)),
            "direction": direction, "reflected": q(torch.where(hit, hb["back_intensity"], 0.0)),
            "initial": intensity, "attenuation": att, "distance": distance_mm,
            "media_id": media_id, "valid": hit | miss,
            "rays": torch.cat([origin, seg_vec], dim=1).T.detach()})
        alive_next = hit & (hb["new_intensity"] > eps)
        t0_next = fdiv((distance_mm + dist_mm) * 1000.0, p["speed_of_sound"])
        alive_next = alive_next & (t0_next < window_us)
        src = q(torch.where(hit[:, None], hb["new_from"], src))
        direction = q(torch.where(hit[:, None], hb["new_direction"], direction))
        media_id = torch.where(hit, hb["new_media_id"], media_id)
        media_outside_id = torch.where(hit, hb["new_media_outside_id"], media_outside_id)
        intensity = q(torch.where(hit, hb["new_intensity"], intensity))
        distance_mm = q(torch.where(hit, distance_mm + dist_mm, distance_mm))
        alive = alive_next
    out = {k: torch.stack([s[k] for s in segments]) for k in segments[0]}
    out["element"] = elem_idx.expand(p["max_depth"], n)
    return out


def hit_boundary(direction, hit_point, surface_normal, intensity, media_id, media_outside_id,
                 mesh_id, materials, mesh_in, mesh_out, mesh_vasc, eps, bd):
    """``trace.hit_boundary`` with the refracted angle's derivative 0 where
    ``refr_sq`` is exactly 0 (its value there, 0, as the description's)."""
    mesh_id_c = mesh_id.clamp(min=0).long()
    m_in = mesh_in.index_select(0, mesh_id_c).int()
    m_out = mesh_out.index_select(0, mesh_id_c).int()
    vascular = mesh_vasc.index_select(0, mesh_id_c)
    in_vessel = media_outside_id >= 0
    none = torch.full_like(media_id, -1)
    o2 = torch.where(media_outside_id == m_in, m_out, m_in)
    m4 = torch.where(media_id == m_in, m_out, m_in)
    mat_after = torch.where(in_vessel, torch.where(vascular, media_outside_id, media_id),
                            torch.where(vascular, m_in, m4))
    out_after = torch.where(in_vessel, torch.where(vascular, none, o2),
                            torch.where(vascular, media_id, none))

    rows_media = take_rows(materials, media_id)
    rows_after = take_rows(materials, mat_after)
    exponent = 1.0 / (torch.floor(rows_after[:, SHININESS]) + 1.0)
    random_angle = torch.pow(bd["angle_u"], exponent)
    random_normal = random_unit_vector(bd["axis_u"], bd["radius_u"], surface_normal,
                                       random_angle)
    incidence = torch.abs(dot3(direction, random_normal))
    z1 = rows_media[:, IMPEDANCE]
    z2 = rows_after[:, IMPEDANCE]
    ratio = z1 / z2
    refr_sq = 1.0 - ratio * ratio * (1.0 - incidence * incidence)
    tir = refr_sq < 0.0
    refracts = refr_sq > 0.0  # the departure: sqrt's infinite derivative at 0 taken as 0
    refr_angle = torch.where(refracts, torch.sqrt(torch.where(refracts, refr_sq, 1.0)), 0.0)
    refr_dir = normalize(ratio[..., None] * direction
                         + (ratio * incidence - refr_angle)[..., None] * random_normal, eps=1e-20)
    refl_dir = normalize(direction + 2.0 * incidence[..., None] * random_normal, eps=1e-20)
    num = z1 * incidence - z2 * refr_angle
    denom = z1 * incidence + z2 * refr_angle
    i_refl = torch.where(tir, intensity, intensity * torch.square(num / denom))
    i_refr = intensity - i_refl
    spec = rows_after[:, SPECULARITY]
    refr_term = torch.where(tir, 0.0, safe_pow(dot3(direction, refr_dir), spec))
    back = (refr_term + safe_pow(dot3(direction, refl_dir), spec)) * random_angle
    reflect = (i_refl / torch.clamp(intensity, min=eps)) > bd["roulette_u"]
    refl_int = torch.where(i_refl > eps, i_refl, 0.0)
    refr_int = torch.where(i_refr > eps, i_refr, 0.0)
    return {"back_intensity": back, "new_from": hit_point,
            "new_direction": torch.where(reflect[..., None], refl_dir, refr_dir),
            "new_media_id": torch.where(reflect, media_id, mat_after),
            "new_media_outside_id": torch.where(reflect, media_outside_id, out_after),
            "new_intensity": torch.where(reflect, refl_int, refr_int)}


# --- the scatterer field, soft and trilinear ----------------------------------------

def _wrap(q: torch.Tensor, size: int) -> torch.Tensor:
    return q & (size - 1) if size & (size - 1) == 0 else \
        torch.remainder(torch.remainder(q, size) + size, size)


def _fields(seeds, ix, iy, iz, size: int):
    vid = ((ix * size + iy) * size + iz) & MASK32
    return _bitsum_normal(hash_u32(vid ^ seeds[0])), _bitsum_normal(hash_u32(vid ^ seeds[1]))


def scattering(seeds, density, mu, sigma, points, p):
    """Amplitude at ``points`` (..., 3) by the description: the nearest voxel
    (truncation, wrapped) or, with ``trilinear_texture``, the eight voxels
    around ``points / res - 0.5`` weighted by the products of the fractions
    (x, then y, then z; the voxels in x-, y-, z-major order); then
    ``noise * sigma + mu`` behind the hard gate ``prob >= density`` or, with
    ``soft_scattering``, times ``sigmoid((prob - density) / tau)``."""
    res, size = p["resolution_um"] / 1000.0, p["volume_size"]
    if p["trilinear_texture"]:
        f = [fdiv(points[..., a], res) - 0.5 for a in range(3)]
        i0 = [torch.floor(x) for x in f]
        w = [x - fl for x, fl in zip(f, i0)]
        i0 = [x.long() for x in i0]
        noise = prob = torch.zeros_like(f[0])
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    n_t, p_t = _fields(seeds, *(_wrap(i + o, size)
                                                for i, o in zip(i0, (dx, dy, dz))), size)
                    wx, wy, wz = (wa if o else 1.0 - wa for wa, o in zip(w, (dx, dy, dz)))
                    wt = wx * wy * wz
                    noise = noise + n_t * wt
                    prob = prob + p_t * wt
    else:
        ix, iy, iz = (_wrap(torch.trunc(fdiv(points[..., a], res)).long(), size)
                      for a in range(3))
        noise, prob = _fields(seeds, ix, iy, iz, size)
    value = noise * sigma + mu
    if p["soft_scattering"]:
        return value * torch.sigmoid(fdiv(prob - density, p["soft_scattering_tau"]))
    return torch.where(prob >= density, value, 0.0)


# --- the march ---------------------------------------------------------------------

def march(segments, materials, seeds, p, n_cols: int, q):
    """``imaging.march`` with this file's ``scattering``, each segment's
    contribution recomputed in the backward: the (rf_rows, n_cols) RF image,
    differentiable in the segments and the material table."""
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

    def segment(fx, fy, fz, dx, dy, dz, seg_t0, seg_steps, ln, i0, mu0, mu1, sigma, valid):
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
        matched = matched & valid
        scale = k_sel * axres
        points = torch.stack([fx + scale * dx, fy + scale * dy, fz + scale * dz], dim=-1)
        scat = scattering(seeds, mu1, mu0, sigma, points, p)
        return torch.where(matched, i0 * torch.exp(ln * k_sel) * scat, 0.0)

    acc = torch.zeros((g["rf_rows"], n_cols), dtype=torch.float32, device=t0.device)
    names = ("fx", "fy", "fz", "dx", "dy", "dz", "t0", "steps", "ln_att", "i0", "mu0", "mu1",
             "sigma", "valid")
    for i in range(s * d):
        args = [f[k][i] for k in names]
        if torch.is_grad_enabled() and any(a.requires_grad for a in args):
            acc = acc + checkpoint(segment, *args, use_reentrant=False)
        else:
            acc = acc + segment(*args)
        acc = acc + torch.where(rows_f == f["b_row"][i], f["b_val"][i], 0.0)
    return q(acc)
