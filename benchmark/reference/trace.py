"""Monte-Carlo path tracing of the probe's elements x samples paths, in plain
torch: the probe's element layout, the keyed draws, the bounce physics and the
listed closest hit (per 512-ray packet the clusters some ray's box test
reaches, walked front to back; strict ``<`` keeps the first winner in walk
order). The arithmetic follows the simulator's formulas operation by
operation, each a separate rounding, so the same inputs give the same bits.
"""

from __future__ import annotations

import math

import torch

from . import rng
from .scene import Clusters

NO_HIT_T = 2.0
BIG = 1e30
IMPEDANCE, ATTENUATION, MU0, MU1, SIGMA, SPECULARITY, SHININESS, THICKNESS = range(8)


def fdiv(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as an IEEE f32 division (a 0-dim tensor divisor)."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def safe_sqrt(x):
    ok = x > 0.0
    return torch.where(ok, torch.sqrt(torch.where(ok, x, 1.0)), 0.0)


def safe_norm(v, keepdim: bool = False):
    n = safe_sqrt(dot3(v, v))
    return n[..., None] if keepdim else n


def normalize(v, eps: float = 0.0):
    return v / torch.clamp(safe_norm(v, keepdim=True), min=eps if eps else 1e-30)


def rotate(v, axis, angle):
    """Rodrigues rotation of ``v`` about the unit ``axis`` by ``angle``."""
    axis = axis.to(v.dtype)
    o = axis * dot3(axis, v)[..., None]
    x = v - o
    y = cross3(axis.expand_as(v), v)
    return o + x * torch.cos(angle) + y * torch.sin(angle)


def element_layout(position, angles_deg, p):
    """The convex arc's element positions and beam directions for B poses
    (B, 3): (B x E, 3) each, pose-major."""
    n = p["transducer_elements"]
    radius_mm = p["transducer_radius_cm"] * 10.0
    sep_mm = math.radians(p["transducer_amplitude_deg"]) * radius_mm / n
    pitch = sep_mm / radius_mm
    angle0 = -(pitch * n / 2.0) + pitch / 2.0
    angles = angle0 + pitch * torch.arange(n, dtype=torch.float32, device=position.device)
    v = torch.stack([torch.sin(angles), torch.cos(angles), torch.zeros_like(angles)], dim=-1)
    rad = torch.deg2rad(angles_deg.float())[..., None, :]
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    v = rotate(v, eye[2], rad[..., 2:3])
    v = rotate(v, eye[0], rad[..., 0:1])
    directions = rotate(v, eye[1], rad[..., 1:2])
    positions = position.float()[..., None, :] + p["transducer_radius_cm"] * directions
    return positions.reshape(-1, 3), directions.reshape(-1, 3)


def draws(frame_keys, p, device):
    """The (D, B x N) draws of B frames, keyed ``fold_in(fold_in(frame key,
    0), path id)`` and then by the bounce's key chain."""
    n_paths = p["transducer_elements"] * p["samples_per_element"]
    trace_keys = rng.fold_in(frame_keys, 0).to(device)
    ids = torch.arange(n_paths, dtype=torch.int64, device=device)
    path_keys = rng.fold_in(trace_keys[..., None, :], ids).reshape(-1, 2)
    depths = torch.arange(p["max_depth"], dtype=torch.int64, device=device)
    ks = rng.split(rng.fold_in(path_keys[None], depths[:, None]), 2)
    ks2 = rng.split(ks[:, :, 1], 3)
    rks = rng.split(ks2[:, :, 1], 2)
    u = rng.uniform(torch.stack([ks[:, :, 0], ks2[:, :, 0], rks[:, :, 0], rks[:, :, 1],
                                 ks2[:, :, 2]]))
    return {"q_normal": rng.normal_from_uniform(u[0]), "angle_u": torch.clamp(u[1], min=1e-12),
            "axis_u": u[2], "radius_u": u[3], "roulette_u": u[4]}


# --- the bounce physics --------------------------------------------------------

def take_rows(table, ids):
    m = table.shape[0]
    flat = ids.reshape(-1).long().clamp(0, m - 1)
    return table.index_select(0, flat).reshape(ids.shape + table.shape[1:])


def safe_pow(base, exponent):
    ok = base > 0.0
    return torch.where(ok, torch.pow(torch.where(ok, base, 1.0), exponent), 0.0)


def random_unit_vector(u_a, u_r, v, cos_theta):
    a = u_a * (2.0 * math.pi)
    r = 0.5 * torch.sqrt(u_r)
    px = r * torch.cos(a)
    py = r * torch.sin(a)
    q = torch.clamp(px * px + py * py, min=1e-12)
    vx0, vy0, vz = v[..., 0], v[..., 1], v[..., 2]
    flag = torch.abs(vx0) > torch.abs(vy0)
    vx = torch.where(flag, vy0, vx0)
    vy = torch.where(flag, vx0, vy0)
    b = torch.clamp(1.0 - vx * vx, min=1e-12)
    c = torch.sqrt(torch.clamp((1.0 - cos_theta * cos_theta) / (q * b), min=1e-20))
    px = px * c
    py = py * c
    d = cos_theta - vx * px
    wx = vx * cos_theta - b * px
    wy = vy * d + vz * py
    wz = vz * d - vy * py
    return torch.stack([torch.where(flag, wy, wx), torch.where(flag, wx, wy), wz], dim=-1)


def hit_boundary(direction, hit_point, surface_normal, intensity, media_id, media_outside_id,
                 mesh_id, materials, mesh_in, mesh_out, mesh_vasc, eps, bd):
    """The boundary interaction of one bounce (id-based media transition)."""
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
    refr_angle = torch.where(tir, 0.0,
                             torch.sqrt(torch.where(tir, 1.0, torch.clamp(refr_sq, min=0.0))))
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


# --- the listed closest hit ----------------------------------------------------

def moller_trumbore(origin, seg, v0, e1, e2, eps: float = 1e-9):
    pvec = cross3(seg, e2)
    det = dot3(e1, pvec)
    det_ok = torch.abs(det) > eps
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, torch.ones_like(det)), 0.0)
    tvec = origin - v0
    u = dot3(tvec, pvec) * inv_det
    qvec = cross3(tvec, e1)
    v = dot3(seg, qvec) * inv_det
    t = dot3(e2, qvec) * inv_det
    valid = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0) & (t < 1.0)
    return t, valid


def inverse_dirs(s):
    ok = torch.abs(s) > 1e-30
    return torch.where(ok, 1.0 / torch.where(ok, s, torch.ones_like(s)), BIG)


def slab(o, inv, box):
    enter = leave = None
    for ax in range(3):
        t0 = (box[..., ax] - o[..., ax]) * inv[..., ax]
        t1 = (box[..., 3 + ax] - o[..., ax]) * inv[..., ax]
        mn, mx = torch.minimum(t0, t1), torch.maximum(t0, t1)
        enter = mn if enter is None else torch.maximum(enter, mn)
        leave = mx if leave is None else torch.minimum(leave, mx)
    return enter, leave


def packet_lists(o, s, clusters: Clusters, tile_r: int):
    """Per packet the clusters some ray's box test reaches inside its segment,
    ascending in the packet's earliest entry (stable in cluster id)."""
    p = o.shape[0] // tile_r
    o = o.reshape(p, tile_r, 3)
    s = s.reshape(p, tile_r, 3)
    enter, leave = slab(o[:, :, None], inverse_dirs(s)[:, :, None], clusters.boxes[None, None])
    hit = (enter <= leave) & (leave > 0.0) & (enter < 1.0)
    any_hit = hit.any(dim=1)
    key = torch.where(hit, torch.clamp(enter, min=0.0), torch.inf).amin(dim=1)
    key = torch.where(any_hit, key, torch.inf)
    keys_sorted, ids = torch.sort(key, dim=1, stable=True)
    return any_hit.sum(dim=1).int(), ids.int(), torch.clamp(keys_sorted, max=NO_HIT_T)


def listed_walk(rays, counts, ids, keys, t, idx, clusters: Clusters, group=None):
    """Each packet walks its list; a cluster's triangles are tested where some
    ray of the packet enters its box before its running t; the walk goes on
    while the next key is below the packet's worst running t. ``group`` rays
    of a packet (None: all) walk its list on their own, with their own box
    test and their own stop."""
    p = counts.shape[0]
    tile_r = rays.shape[1] // p
    if group is not None:
        k = tile_r // group
        counts, ids, keys = (x.repeat_interleave(k, dim=0) for x in (counts, ids, keys))
        p, tile_r = p * k, group
    o = rays[0:3].T.reshape(p, tile_r, 3)
    s = rays[3:6].T.reshape(p, tile_r, 3)
    inv = inverse_dirs(s)
    t = t.reshape(p, tile_r).clone()
    idx = idx.reshape(p, tile_r).clone()
    n_c = ids.shape[1]
    go = counts > 0
    for it in range(n_c):
        if not bool(go.any()):
            break
        nxt = min(it + 1, n_c - 1)
        want_next = go & (it + 1 < counts) & (keys[:, nxt] < t.amax(dim=1))
        c = ids[:, it]
        tiles = clusters.tiles.index_select(0, c.long())
        enter, leave = slab(o, inv, tiles[:, 9:15, 0][:, None])
        active = (enter <= leave) & (leave > 0.0) & (enter < torch.clamp(t, max=1.0))
        take = go & active.any(dim=1)
        v0, e1, e2 = (tiles[:, r:r + 3].transpose(1, 2)[:, None] for r in (0, 3, 6))
        tt, valid = moller_trumbore(o[:, :, None], s[:, :, None], v0, e1, e2)
        tmin, targ = torch.where(valid, tt, NO_HIT_T).min(dim=2)
        better = take[:, None] & (tmin < t)
        t = torch.where(better, tmin, t)
        idx = torch.where(better, (c * clusters.tile_t)[:, None] + targ.int(), idx)
        go = want_next
    return t.reshape(-1), idx.reshape(-1)


def closest_hit(origins, seg_vecs, clusters: Clusters, tile_r: int, group=None):
    """The hit record of each segment's closest triangle, listed."""
    n = origins.shape[0]
    n_pad = (-n) % tile_r
    o, s = origins, seg_vecs
    if n_pad:
        o = torch.cat([o, o.new_full((n_pad, 3), 0.0)])
        s = torch.cat([s, s.new_zeros((n_pad, 3))])
    rays = torch.cat([o, s], dim=1).T.contiguous()
    counts, ids, keys = packet_lists(o, s, clusters, tile_r)
    live = torch.abs(s).sum(dim=1) > 0.0
    t0 = torch.where(live, NO_HIT_T, 0.0)
    best_t, best_slot = listed_walk(rays, counts, ids, keys, t0,
                                    torch.zeros_like(t0, dtype=torch.int32), clusters, group)
    hit = live[:n] & (best_t[:n] < 1.5)
    rows = clusters.slot_all.index_select(0, torch.clamp(best_slot[:n],
                                                          max=clusters.n_slots - 1).long())
    v0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    t_hit, _ = moller_trumbore(origins, seg_vecs, v0, e1, e2)
    t_hit = torch.where(hit, t_hit, NO_HIT_T)
    face_n = normalize(cross3(e1, e2), eps=1e-20)
    flip = dot3(face_n, seg_vecs) > 0.0
    return {"hit": hit, "point": origins + t_hit[:, None] * seg_vecs,
            "normal": torch.where(flip[:, None], -face_n, face_n),
            "mesh_id": torch.where(hit, rows[:, 9].int(), -1)}


# --- the trace -----------------------------------------------------------------

def trace(bd_all, tables, positions, angles, p, clusters: Clusters, tile_r: int, q=None,
          group=None):
    """The (D, N) segments of B poses' paths (``draws`` ``bd_all``); ``q``
    rounds what a bounce keeps (the control), else None; ``group`` goes to
    the closest hit."""
    q = q or (lambda x: x)
    n_samples = p["samples_per_element"]
    freq, eps = p["transducer_frequency"], p["intensity_epsilon"]
    window_us = float(int(p["ultrasound_depth_cm"] * 1e4 / p["speed_of_sound"]))
    elem_pos, elem_dir = element_layout(positions, angles, p)
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
        r_length = 10.0 * torch.log(torch.full_like(inten, eps) / inten) / -att * freq
        origin = src + p["ray_start_offset"] * direction
        dest = src + fdiv(r_length[:, None], 100.0) * spacing * direction
        alive_col = alive[:, None]
        seg_vec = (dest - origin) * alive_col
        origin = torch.where(alive_col, origin, 1e9)
        hits = closest_hit(origin, seg_vec, clusters, tile_r, group)
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
            "rays": torch.cat([origin, seg_vec], dim=1).T})
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
