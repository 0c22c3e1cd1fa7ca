"""The bounce physics as one kernel a bounce (``csrc/bounce.cu``).

Replaces no TPU kernel: the reference traces in jnp
(``mcray_tpu/models/simulator.py:trace_paths``, ``ops/physics.py``), which XLA
fuses. The plain version is the port's own composition: ``rays_plain`` (a
bounce's closest-hit query from the path state) and ``bounce_plain`` (what
a path does after its closest hit: the fuzz, the travel, ``hit_boundary``,
the segment and the next state), ~300 elementwise launches a bounce on the
card. ``bounce_physics_kernel`` runs both in one launch a bounce, one thread a
path, and writes the segments straight into the trace's (D + 1, N, ...)
record, bit for bit the plain version (the source's note has the layout and
the bound).

``Bounces`` runs the D bounces of a trace around its closest hits, one
launch at a time: the kernel for CUDA tensors, the plain version for CPU
tensors, which it writes into the same record. Each launch is an
``autograd.Function`` whose backward is the hand-derived adjoint of the
launch, recomputed from the record's row it started from (the record holds
the state each bounce started from): one launch of
``bounce_physics_bwd_kernel`` for CUDA tensors, its plain twin
(``bounce_adjoint_plain``, ``start_adjoint_plain``) for CPU tensors. The
twin is autograd over the plain version lane for lane and sums the table's
gradient in the kernel's fixed order (``table_grad``); the tests hold it to
autograd over the plain version rerun (``tests/_bounce_rerun.py``, the
yardstick no backward takes) and the kernel to both. ``launch_counts()`` counts the
kernel's launches under ``bounce`` and the backward's under
``bounce_bwd``: D + 1 a trace each (row 0, then one a bounce).
"""

from __future__ import annotations

import ctypes

import torch

from ...config import SimConfig
from .. import physics
from ..geometry import distance_in_mm, dot3
from ..texture import fdiv
from . import _build
from .draws import FIELDS


#: the segment fields of a trace, in the order ``trace_paths`` returns them
SEGMENT_FIELDS = ("from", "to", "direction", "reflected", "initial", "attenuation", "distance",
                  "media_id", "valid", "rays")
#: the path state a bounce starts from
STATE_FIELDS = ("src", "direction", "media_id", "media_outside_id", "intensity", "distance_mm",
                "alive")
#: the fields of a record row that carry a gradient: the state, then the
#: query (attenuation, far end ``to``, and ``query``: (origin, segment))
GRADED_ROW = ("from", "direction", "initial", "distance", "attenuation", "to", "query")

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _Args(ctypes.Structure):
    """``McrayBounceArgs`` of ``csrc/bounce.cu``, field for field."""
    _fields_ = [
        ("positions", P), ("directions", P), ("local_samples", I), ("starting_material", I),
        ("initial_intensity", F),
        ("hit", P), ("point", P), ("normal", P), ("mesh_id", P),
        *((name, P) for name in FIELDS),
        ("materials", P), ("n_materials", I), ("mesh_inside", P), ("mesh_outside", P),
        ("mesh_vascular", P), ("n_mesh", I), ("spacing", P),
        ("from_", P), ("to", P), ("direction", P), ("reflected", P), ("initial", P),
        ("attenuation", P), ("distance", P), ("media_id", P), ("valid", P), ("outside", P),
        ("query", P),
        ("eps", F), ("eps_floor", F), ("frequency", F), ("ray_start_offset", F),
        ("speed_of_sound", F), ("max_travel_time_us", F),
        ("bug_compat_material_transition", I), ("cull_time_window", I),
        ("n", I), ("depth", I), ("first", I),
    ]


class _BwdArgs(ctypes.Structure):
    """``McrayBounceBwdArgs`` of ``csrc/bounce.cu``, field for field."""
    _fields_ = [
        ("fwd", _Args),
        ("g_to", P), ("g_reflected", P), ("g_from", P), ("g_direction", P), ("g_initial", P),
        ("g_distance", P), ("g_attenuation", P), ("g_far", P), ("g_query", P),
        ("d_from", P), ("d_direction", P), ("d_initial", P), ("d_distance", P),
        ("d_attenuation", P), ("d_to", P), ("d_point", P), ("d_normal", P),
        ("d_materials", P), ("partials", P), ("path_grads", P), ("d_positions", P),
        ("d_directions", P), ("n_elements", I),
    ]


def initial_state(positions, directions, local_samples: int, starting_material: int,
                  cfg: SimConfig) -> dict:
    """The path state of bounce 0: path i at ``positions[i //
    local_samples]`` along ``directions[i // local_samples]``, in
    ``starting_material``, with ``cfg.initial_intensity / samples_per_element``."""
    n = positions.shape[0] * local_samples
    device = positions.device
    return {
        "src": positions.repeat_interleave(local_samples, dim=0),
        "direction": directions.repeat_interleave(local_samples, dim=0),
        "media_id": torch.full((n,), starting_material, dtype=torch.int32, device=device),
        "media_outside_id": torch.full((n,), -1, dtype=torch.int32, device=device),
        "intensity": torch.full((n,), cfg.initial_intensity / cfg.samples_per_element,
                                dtype=torch.float32, device=device),
        "distance_mm": torch.zeros((n,), dtype=torch.float32, device=device),
        "alive": torch.ones((n,), dtype=torch.bool, device=device),
    }


def thickness_by_mesh(materials, scene: dict):
    """Each mesh's inside thickness, so the per-ray lookup is one small gather
    (in the table's dtype: ``physics.take_rows`` rounds the per-ray rows)."""
    ids = scene["mesh_mat_inside"].long().clamp(0, materials.shape[0] - 1)
    return materials[:, physics.THICKNESS].index_select(0, ids)


def rays_plain(state: dict, materials, spacing, cfg: SimConfig) -> dict:
    """A bounce's closest-hit query from the path ``state``: the medium's
    ``attenuation``, the far end ``dest`` of the attenuation-bounded reach,
    and the ray as the closest hit takes it, ``origin`` (parked far away on
    a dead path) and ``seg_vec`` (zero on a dead path: it hits nothing)."""
    src, direction, alive = state["src"], state["direction"], state["alive"]
    eps = cfg.intensity_epsilon
    att = physics.take_rows(materials[:, physics.ATTENUATION], state["media_id"])
    r_length = physics.max_ray_length(torch.clamp(state["intensity"], min=eps * 1e-3), att,
                                      cfg.transducer_frequency, eps)
    origin = src + cfg.ray_start_offset * direction
    # enlarge(): mm/100 with per-axis spacing (src/scene.cpp:292-298).
    # r_length is detached: it only sets the ray's reach (hit or no hit);
    # the hit point does not move with the segment's scale, so its
    # analytic gradient is zero, but in f32 it is a cancellation of huge
    # log(eps/I)/att^2 terms that would pour noise into the material
    # gradients (as the reference, models/simulator.py:136-143)
    reach = fdiv(r_length.detach()[:, None], 100.0)
    dest = src + reach * spacing * direction
    # dead rays get a zero segment parked far away: det == 0, so they miss
    alive_col = alive[:, None]
    seg_vec = (dest - origin) * alive_col
    origin = torch.where(alive_col, origin, 1e9)
    return {"attenuation": att, "dest": dest, "origin": origin, "seg_vec": seg_vec, "reach": reach}


def bounce_parts(hits: dict, draws: dict, state: dict, query: dict, materials, thick_by_mesh,
                 scene: dict, spacing, cfg: SimConfig, parts: bool = False) -> dict:
    """``bounce_plain`` with its intermediates: ``segment`` and ``next``,
    the lanes that hit (``hit``), the thickness and the fuzz (``thick``,
    ``q``), the point inside (``inside``), the distance travelled
    (``dist_mm``), the intensity at the boundary (``travelled``) and
    ``physics.hit_boundary``'s result (``hb``, with its own intermediates
    for ``parts``)."""
    src, direction, intensity = state["src"], state["direction"], state["intensity"]
    distance_mm, media_id, alive = state["distance_mm"], state["media_id"], state["alive"]
    att, dest = query["attenuation"], query["dest"]
    eps = cfg.intensity_epsilon
    hit = hits["hit"] & alive

    # sub-surface penetration fuzz: q ~ |N(0, thickness_inside)| (src/scene.cpp:129-139)
    thick = physics.take_rows(thick_by_mesh, hits["mesh_id"].clamp(min=0))
    q = torch.abs(draws["q_normal"] * thick)
    inside_point = hits["point"] + q[:, None] * direction

    dist_mm = distance_in_mm(src, inside_point, spacing)
    intensity_travelled = intensity * physics.travel_attenuation(att, dist_mm,
                                                                 cfg.transducer_frequency)
    hb = physics.hit_boundary(
        direction, hits["point"], hits["normal"], intensity_travelled,
        media_id, state["media_outside_id"], hits["mesh_id"], materials,
        scene["mesh_mat_inside"], scene["mesh_mat_outside"], scene["mesh_is_vascular"], cfg,
        draws=draws, parts=parts,
    )
    miss = alive & ~hits["hit"]
    segment = {
        "from": src,
        "to": torch.where(hit[:, None], inside_point, dest),
        "direction": direction,
        "reflected": torch.where(hit, hb["back_intensity"], 0.0),
        "initial": intensity,
        "attenuation": att,
        "distance": distance_mm,
        "media_id": media_id,
        "valid": hit | miss,
    }

    alive_next = hit & (hb["new_intensity"] > eps)
    if cfg.cull_time_window:
        # the continuation's segment would start at t0 >= the window: none
        # of its echoes can land in the RF image
        t0_next = fdiv((distance_mm + dist_mm) * 1000.0, cfg.speed_of_sound)
        alive_next = alive_next & (t0_next < float(cfg.max_travel_time_us))
    nxt = {
        "src": torch.where(hit[:, None], hb["new_from"], src),
        "direction": torch.where(hit[:, None], hb["new_direction"], direction),
        "media_id": torch.where(hit, hb["new_media_id"], media_id),
        "media_outside_id": torch.where(hit, hb["new_media_outside_id"],
                                        state["media_outside_id"]),
        "intensity": torch.where(hit, hb["new_intensity"], intensity),
        "distance_mm": torch.where(hit, distance_mm + dist_mm, distance_mm),
        "alive": alive_next,
    }
    return {"segment": segment, "next": nxt, "hit": hit, "thick": thick, "q": q,
            "inside": inside_point,
            "dist_mm": dist_mm, "travelled": intensity_travelled, "hb": hb}


def bounce_plain(hits: dict, draws: dict, state: dict, query: dict, materials, thick_by_mesh,
                 scene: dict, spacing, cfg: SimConfig) -> tuple[dict, dict]:
    """A bounce after its closest hit ``hits``, with the bounce's (N,)
    ``draws`` and ``query``'s ``attenuation`` and ``dest`` (``rays_plain``'s):
    the sub-surface fuzz, the travel to the hit, the boundary
    (``physics.hit_boundary``). Returns the bounce's segment (its ray is the
    query's) and the path state of the next bounce."""
    parts = bounce_parts(hits, draws, state, query, materials, thick_by_mesh, scene, spacing, cfg)
    return parts["segment"], parts["next"]


def row_of(state: dict, query: dict) -> dict:
    """A record row from a path ``state`` and its ``rays_plain`` query."""
    return {"from": state["src"], "direction": state["direction"], "initial": state["intensity"],
            "distance": state["distance_mm"], "attenuation": query["attenuation"],
            "to": query["dest"], "query": torch.stack([query["origin"], query["seg_vec"]]),
            "media_id": state["media_id"], "outside": state["media_outside_id"],
            "valid": state["alive"]}


def state_of(row: dict) -> dict:
    """The path state a record row holds, by ``STATE_FIELDS``."""
    return {"src": row["from"], "direction": row["direction"], "media_id": row["media_id"],
            "media_outside_id": row["outside"], "intensity": row["initial"],
            "distance_mm": row["distance"], "alive": row["valid"]}


def row_as_query(row: dict) -> dict:
    """The query a record row holds, as ``rays_plain`` returns it."""
    return {"attenuation": row["attenuation"], "dest": row["to"], "origin": row["query"][0],
            "seg_vec": row["query"][1]}


#: paths a block of the backward kernel takes: a launch's table gradient is
#: summed per block, path by path and slot by slot, then over the blocks in order
BWD_BLOCK = 64
#: the table columns of a path-bounce's five contributions to the table's
#: gradient, its slots: the next row's attenuation, the impedance of the
#: medium and of the medium after the boundary, the specularity, the thickness
SLOT_COLUMNS = (physics.ATTENUATION, physics.IMPEDANCE, physics.IMPEDANCE,
                physics.SPECULARITY, physics.THICKNESS)


def table_grad(values, rows, columns, n_materials: int):
    """The (M, 8) table gradient of per-path contributions ``values`` (N, S)
    at rows ``rows`` (N, S; clamped as ``take_rows`` clamps them) and
    columns ``columns`` (S,), summed as the kernel sums them: in double, each
    block of BWD_BLOCK paths in path then slot order (``index_add_`` on the
    CPU adds in the order of its source), then over the blocks, rounded to
    f32 once (the kernel adds the blocks by a tree: in double the order
    moves the f32 result only at a tie)."""
    n, e = values.shape[0], n_materials * 8
    device = values.device
    blocks = -(-n // BWD_BLOCK)
    block = torch.arange(n, device=device) // BWD_BLOCK
    cols = torch.tensor(columns, device=device)
    target = block[:, None] * e + rows.long().clamp(0, n_materials - 1) * 8 + cols
    partials = values.new_zeros(blocks * e, dtype=torch.float64).index_add_(
        0, target.reshape(-1), values.reshape(-1).double())
    entry = torch.arange(blocks * e, device=device) % e
    total = partials.new_zeros(e).index_add_(0, entry, partials)
    return total.float().view(n_materials, 8)


def query_adjoint(alive, factor, offset: float, g_from, g_direction, g_to, g_query):
    """The adjoint of a record row's ``from``, ``direction``, ``to`` and
    ``query`` (``row_of`` of ``rays_plain``) in its state's ``src`` and
    ``direction``: ``factor`` (N, 3) is the far end's reach times the
    spacing, ``offset`` the ray's start offset. The reach carries no
    gradient (``rays_plain`` detaches it); a dead path's origin is parked
    and its segment zero."""
    live = alive[:, None].to(g_from.dtype)
    g_dest = g_to + g_query[1] * live
    g_origin = torch.where(alive[:, None], g_query[0], 0.0) - g_query[1] * live
    return g_from + g_dest + g_origin, g_direction + g_dest * factor + g_origin * offset


def _safe_pow_adjoint(base, exponent, g):
    """The adjoint of ``physics.safe_pow``: (in ``base``, in ``exponent``),
    0 where the base is not positive, as autograd gives it."""
    ok = base > 0.0
    b = torch.where(ok, base, 1.0)
    g_base = torch.where(ok & (exponent != 0.0), g * (exponent * torch.pow(b, exponent - 1.0)), 0.0)
    g_exponent = torch.where(ok, g * (torch.pow(b, exponent) * torch.log(b)), 0.0)
    return g_base, g_exponent


def _normalize_adjoint(v, g):
    """The adjoint of ``geometry.normalize(v, eps=1e-20)`` in ``v``."""
    ss = dot3(v, v)
    ok = ss > 0.0
    norm = torch.where(ok, torch.sqrt(torch.where(ok, ss, 1.0)), 0.0)
    n = torch.clamp(norm, min=1e-20)[:, None]
    # autograd's division backward: -g ((v / n) / n), summed over the axes
    t = -g * ((v / n) / n)
    g_n = t[:, 0] + t[:, 1] + t[:, 2]
    g_ss = torch.where(ok & (norm >= 1e-20), g_n / (2.0 * norm), 0.0)
    return g / n + (2.0 * g_ss)[:, None] * v


def _random_unit_vector_adjoint(u_a, u_r, v, cos_theta, g):
    """The adjoint of ``physics.random_unit_vector_from_uniforms`` in ``v``
    (the surface normal): the draws and ``cos_theta`` (the power-cosine
    angle, a power of a draw by a floored shininess) carry none."""
    k = physics.random_unit_vector_parts(u_a, u_r, v, cos_theta)
    flag, vx, vy, vz, b, px, py, d = (k[n] for n in ("flag", "vx", "vy", "vz", "b", "px", "py",
                                                      "d"))
    g_wx = torch.where(flag, g[:, 1], g[:, 0])
    g_wy = torch.where(flag, g[:, 0], g[:, 1])
    g_wz = g[:, 2]
    # wx = vx ct - b px; wy = vy d + vz py; wz = vz d - vy py
    g_vx = g_wx * cos_theta
    g_b = -(g_wx * px)
    g_px = -(g_wx * b)
    g_vy = g_wy * d - g_wz * py
    g_vz = g_wy * py + g_wz * d
    g_d = g_wy * vy + g_wz * vz
    g_py = g_wy * vz - g_wz * vy
    # d = ct - vx px
    g_vx = g_vx - g_d * px
    g_px = g_px - g_d * vx
    # px = px0 c, py = py0 c, c = sqrt(clamp(x0)), x0 = (1 - ct^2) / (p b)
    g_c = g_px * k["px0"] + g_py * k["py0"]
    x0, c, p = k["x0"], k["c"], k["p"]
    g_x0 = torch.where(x0 >= 1e-20, g_c / (2.0 * c), 0.0)
    g_b = g_b - g_x0 * (x0 / (p * b)) * p
    # b = clamp(1 - vx^2)
    g_vx = g_vx - torch.where(k["b0"] >= 1e-12, 2.0 * (g_b * vx), 0.0)
    return torch.stack([torch.where(flag, g_vy, g_vx), torch.where(flag, g_vx, g_vy), g_vz], 1)


def _or_zeros(g, like):
    return torch.zeros_like(like) if g is None else g


def start_adjoint_plain(state: dict, local_samples: int, materials, spacing, cfg: SimConfig,
                        grads: dict, want_table: bool, want_pose: bool) -> dict:
    """Row 0's backward (``_Start``), the plain twin of the backward
    kernel's first mode: from the gradients ``grads`` of row 0's
    ``GRADED_ROW`` fields (None: zero), the gradient of the elements'
    ``positions`` and ``directions`` (``want_pose``: each element's
    ``local_samples`` paths summed in order) and of the table
    (``want_table``: the attenuation's gather, ``table_grad``)."""
    out = {}
    with torch.no_grad():
        query = rays_plain(state, materials, spacing, cfg)
        src = state["src"]
        if want_pose:
            g = {k: _or_zeros(grads.get(k), src) for k in ("from", "direction", "to")}
            g_query = _or_zeros(grads.get("query"), torch.stack([src, src]))
            g_src, g_dir = query_adjoint(state["alive"], query["reach"] * spacing,
                                         cfg.ray_start_offset, g["from"], g["direction"],
                                         g["to"], g_query)
            for name, g_path in (("positions", g_src), ("directions", g_dir)):
                g_path = g_path.view(-1, local_samples, 3)
                total = g_path[:, 0]
                for j in range(1, local_samples):
                    total = total + g_path[:, j]
                out[name] = total
        if want_table:
            g_att = _or_zeros(grads.get("attenuation"), state["intensity"])
            out["materials"] = table_grad(g_att[:, None], state["media_id"][:, None],
                                          SLOT_COLUMNS[:1], materials.shape[0])
    return out


def bounce_adjoint_plain(state: dict, hits: dict, draws: dict, att, dest, materials, scene: dict,
                         spacing, cfg: SimConfig, grads: dict, want_table: bool) -> dict:
    """A bounce's backward (``_Bounce``), the plain twin of the backward
    kernel: the hand-derived adjoint of ``bounce_plain`` and the next row's
    query (``rays_plain``), recomputed from the bounce's path ``state``, its
    closest hit ``hits``, its (N,) ``draws`` and its row's attenuation
    ``att`` and far end ``dest``. ``grads`` holds the gradients of segment
    d's ``to`` and ``reflected`` and of the next row's ``GRADED_ROW`` fields
    (``next``), None for zero. Returns the gradients of the row's
    ``GRADED_ROW`` fields but ``query`` (which the bounce does not read), of
    the hits' ``point`` and ``normal``, and (``want_table``) of the table.

    It keeps the plain version's masks and ``where``s, so that it is
    autograd over the plain version lane for lane: the roulette's choice,
    total internal reflection and the ``> eps`` cut-offs carry no gradient,
    nor does the floored shininess (so neither the power-cosine angle); the
    refracted angle's derivative is 0 where ``refr_sq`` is not positive; a
    path that does not hit passes its row through (its segment's ``to`` is
    the row's far end)."""
    src, u, intensity = state["src"], state["direction"], state["intensity"]
    eps = cfg.intensity_epsilon
    with torch.no_grad():
        parts = bounce_parts(hits, draws, state, {"attenuation": att, "dest": dest}, materials,
                             thickness_by_mesh(materials, scene), scene, spacing, cfg, parts=True)
        nxt, hb, hit = parts["next"], parts["hb"], parts["hit"]
        nq = rays_plain(nxt, materials, spacing, cfg)
        gn = {k: _or_zeros(grads["next"].get(k), like)
              for k, like in (("from", src), ("direction", src), ("initial", intensity),
                              ("distance", intensity), ("attenuation", intensity), ("to", src),
                              ("query", torch.stack([src, src])))}
        g_to = _or_zeros(grads.get("to"), src)
        g_reflected = _or_zeros(grads.get("reflected"), intensity)

        # the next row's query, then the next state: where the path hit,
        # src' = the hit point, direction' and intensity' the roulette's choice
        g_src_n, g_dir_n = query_adjoint(nxt["alive"], nq["reach"] * spacing,
                                         cfg.ray_start_offset, gn["from"], gn["direction"],
                                         gn["to"], gn["query"])
        reflect, tir = hb["chose_reflection"], hb["tir"]
        refl_dir, refr_dir, rn = hb["refl_dir"], hb["refr_dir"], hb["random_normal"]
        inc, ratio, ca, z1, z2 = hb["incidence"], hb["ratio"], hb["refr_angle"], hb["z1"], hb["z2"]
        travelled = parts["travelled"]
        g_i_refl = torch.where(reflect & (hb["i_refl"] > eps), gn["initial"], 0.0)
        g_i_refr = torch.where(~reflect & (hb["i_refr"] > eps), gn["initial"], 0.0)
        g_refl_dir = torch.where(reflect[:, None], g_dir_n, 0.0)
        g_refr_dir = torch.where(reflect[:, None], 0.0, g_dir_n)

        # the backscatter: (safe_pow(u . refr_dir, spec) unless TIR
        # + safe_pow(u . refl_dir, spec)) x the power-cosine angle
        g_term = g_reflected * hb["random_angle"]
        g_cos_refl, g_spec = _safe_pow_adjoint(dot3(u, refl_dir), hb["spec"], g_term)
        g_cos_refr, g_spec_refr = _safe_pow_adjoint(dot3(u, refr_dir), hb["spec"],
                                                    torch.where(tir, 0.0, g_term))
        g_spec = g_spec + g_spec_refr
        g_u = g_cos_refl[:, None] * refl_dir + g_cos_refr[:, None] * refr_dir
        g_refl_dir = g_refl_dir + g_cos_refl[:, None] * u
        g_refr_dir = g_refr_dir + g_cos_refr[:, None] * u

        # Fresnel: i_refr = travelled - i_refl; i_refl = travelled under TIR,
        # else travelled (num / den)^2, num, den = z1 inc -/+ z2 refr_angle
        g_i_refl = g_i_refl - g_i_refr
        num, den = z1 * inc - z2 * ca, z1 * inc + z2 * ca
        ratio_r = num / den
        g_travelled = g_i_refr + torch.where(tir, g_i_refl, g_i_refl * (ratio_r * ratio_r))
        g_ratio_r = g_i_refl * travelled * (2.0 * ratio_r)
        g_num = g_ratio_r / den
        g_den = -g_ratio_r * (ratio_r / den)
        # each product on its own and the denominator's first, as autograd
        # adds them: where refr_angle and the incidence are both ~0 (a grazing
        # path between equal impedances) num / den is 1 and these terms cancel
        # to rounding noise of order 1 / den, which this order reproduces
        g_z1, g_z2, g_inc, g_ca = (torch.where(tir, 0.0, g) for g in (
            g_den * inc + g_num * inc, g_den * ca - g_num * ca,
            g_den * z1 + g_num * z1, g_den * z2 - g_num * z2))

        # the two directions: normalize(ratio u + (ratio inc - refr_angle) rn)
        # and normalize(u + 2 inc rn)
        k = ratio * inc - ca
        twice = 2.0 * inc
        g_refr_v = _normalize_adjoint(ratio[:, None] * u + k[:, None] * rn, g_refr_dir)
        g_refl_v = _normalize_adjoint(u + twice[:, None] * rn, g_refl_dir)
        g_u = g_u + ratio[:, None] * g_refr_v + g_refl_v
        g_k = dot3(g_refr_v, rn)
        g_rn = k[:, None] * g_refr_v + twice[:, None] * g_refl_v
        g_ratio = dot3(g_refr_v, u) + g_k * inc
        g_inc = g_inc + 2.0 * dot3(g_refl_v, rn) + g_k * ratio
        g_ca = g_ca - g_k

        # refr_angle = sqrt(refr_sq) where refr_sq > 0, else 0 (derivative 0);
        # refr_sq = 1 - ratio^2 (1 - inc^2); ratio = z1 / z2
        g_refr_sq = torch.where(hb["refracts"], g_ca / (2.0 * ca), 0.0)
        w = 1.0 - inc * inc
        g_ratio = g_ratio - 2.0 * ((g_refr_sq * w) * ratio)
        g_inc = g_inc + 2.0 * ((g_refr_sq * (ratio * ratio)) * inc)
        g_z1 = g_z1 + g_ratio / z2
        g_z2 = g_z2 - g_ratio * (ratio / z2)

        # incidence = |u . rn|, rn the power-cosine normal about the surface's
        g_cos_in = g_inc * torch.sign(dot3(u, rn))
        g_u = g_u + g_cos_in[:, None] * rn
        g_rn = g_rn + g_cos_in[:, None] * u
        g_normal = _random_unit_vector_adjoint(draws["axis_u"], draws["radius_u"], hits["normal"],
                                               hb["random_angle"], g_rn)

        # the travel: travelled = intensity exp(-att dist_mm 0.01 f)
        f = cfg.transducer_frequency
        dist_mm = parts["dist_mm"]
        travel = physics.travel_attenuation(att, dist_mm, f)
        g_intensity = g_travelled * travel
        g_e1 = g_travelled * intensity * travel * f * 0.01
        g_att = -(g_e1 * dist_mm)
        g_dist = g_e1 * -att + gn["distance"]
        # dist_mm = |(src - inside) spacing| 10; inside = point + q u
        diff = src - parts["inside"]
        span = torch.abs(diff) * spacing
        ss = dot3(span, span)
        norm = torch.where(ss > 0.0, torch.sqrt(torch.where(ss > 0.0, ss, 1.0)), 0.0)
        g_ss = torch.where(ss > 0.0, (g_dist * 10.0) / (2.0 * norm), 0.0)
        g_diff = (2.0 * g_ss)[:, None] * span * spacing * torch.sign(diff)
        g_inside = g_to - g_diff
        g_u = g_u + parts["q"][:, None] * g_inside
        # q = |q_normal thick|
        g_thick = dot3(g_inside, u) * torch.sign(draws["q_normal"] * parts["thick"]) \
            * draws["q_normal"]

        hitc = hit[:, None]
        out = {"from": torch.where(hitc, g_diff, g_src_n),
               "direction": torch.where(hitc, g_u, g_dir_n),
               "initial": torch.where(hit, g_intensity, gn["initial"]),
               "distance": gn["distance"],
               "attenuation": torch.where(hit, g_att, 0.0),
               "to": torch.where(hitc, 0.0, g_to),
               "point": torch.where(hitc, g_inside + g_src_n, 0.0),
               "normal": torch.where(hitc, g_normal, 0.0)}
        if want_table:
            n_mesh = scene["mesh_mat_inside"].shape[0]
            m_in = scene["mesh_mat_inside"][hits["mesh_id"].long().clamp(0, n_mesh - 1)]
            values = torch.stack([gn["attenuation"]] + [torch.where(hit, g, 0.0) for g in
                                                        (g_z1, g_z2, g_spec, g_thick)], 1)
            rows = torch.stack([nxt["media_id"], state["media_id"], hb["mat_after"],
                                hb["mat_after"], m_in], 1)
            out["materials"] = table_grad(values, rows, SLOT_COLUMNS, materials.shape[0])
    return out


class _Record:
    """A trace's (D + 1, N, ...) record and the launches that fill it: row
    d holds the state bounce d starts from and its closest-hit query (the
    fields of segment d but its end ``to`` and ``reflected``, which bounce d
    writes over the query's far end). ``start`` fills row 0 from the
    elements, ``bounce(d, ...)`` runs bounce d and fills row d + 1. On the
    card each is one kernel launch; on the CPU ``start_plain`` and
    ``bounce_plain`` compute them, written through ``.data`` as the kernel
    writes through a pointer, so no row handed to autograd sees its version
    move."""

    def __init__(self, positions, directions, local_samples: int, draws: dict, materials,
                 scene: dict, spacing, starting_material: int, cfg: SimConfig):
        self.cfg, self.scene, self.draws = cfg, scene, draws
        self.local_samples, self.starting_material = local_samples, starting_material
        n = positions.shape[0] * local_samples
        rows, device = cfg.max_depth + 1, positions.device
        f32 = dict(dtype=torch.float32, device=device)
        self.buffers = {
            "from": torch.empty((rows, n, 3), **f32),
            "to": torch.empty((rows, n, 3), **f32),
            "direction": torch.empty((rows, n, 3), **f32),
            "reflected": torch.empty((cfg.max_depth, n), **f32),
            "initial": torch.empty((rows, n), **f32),
            "attenuation": torch.empty((rows, n), **f32),
            "distance": torch.empty((rows, n), **f32),
            "media_id": torch.empty((rows, n), dtype=torch.int32, device=device),
            "valid": torch.empty((rows, n), dtype=torch.bool, device=device),
            "outside": torch.empty((rows, n), dtype=torch.int32, device=device),
            "query": torch.empty((rows, 2, n, 3), **f32),
        }
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"no bounce physics for tensors on {device}")
        self.raw = {k: v.data for k, v in self.buffers.items()}
        if self.card:
            self.args = self._args(positions, directions, materials, spacing, n)

    @property
    def card(self) -> bool:
        """Whether the kernel fills the record (CUDA tensors)."""
        return self.buffers["query"].is_cuda

    def row(self, d: int) -> dict:
        """Row ``d``'s views (``reflected`` on rows [0, D) only)."""
        return {k: v[d] for k, v in self.buffers.items() if k != "reflected" or d < len(v)}

    def _args(self, positions, directions, materials, spacing, n: int) -> _Args:
        """The launches' arguments, the inputs checked and held for the
        trace's length."""
        cfg, scene = self.cfg, self.scene
        self.inputs = [positions.contiguous(), directions.contiguous(), materials.contiguous(),
                       spacing.contiguous(), *(self.draws[k].contiguous() for k in FIELDS)]
        positions, directions, materials, spacing, *fields = self.inputs
        r = positions.shape[0]
        _build.require(positions, "positions", torch.float32, (r, 3))
        _build.require(directions, "directions", torch.float32, (r, 3))
        _build.require(materials, "materials", torch.float32, (materials.shape[0], 8))
        _build.require(spacing, "spacing", torch.float32, (3,))
        for name, field in zip(FIELDS, fields):
            _build.require(field, name, torch.float32, (cfg.max_depth, n))
        n_mesh = scene["mesh_mat_inside"].shape[0]
        _build.require(scene["mesh_mat_inside"], "mesh_mat_inside", torch.int32, (n_mesh,))
        _build.require(scene["mesh_mat_outside"], "mesh_mat_outside", torch.int32, (n_mesh,))
        _build.require(scene["mesh_is_vascular"], "mesh_is_vascular", torch.bool, (n_mesh,))
        shared = _build.library().mcray_bounce_shared_bytes(materials.shape[0], n_mesh)
        if shared > _build.SHARED_BYTES:
            raise ValueError(f"{materials.shape[0]} materials and {n_mesh} meshes take {shared} "
                             f"bytes of shared memory, more than {_build.SHARED_BYTES}")
        b = self.buffers
        return _Args(
            positions=positions.data_ptr(), directions=directions.data_ptr(),
            local_samples=self.local_samples, starting_material=self.starting_material,
            initial_intensity=cfg.initial_intensity / cfg.samples_per_element,
            **{name: f.data_ptr() for name, f in zip(FIELDS, fields)},
            materials=materials.data_ptr(), n_materials=materials.shape[0],
            mesh_inside=scene["mesh_mat_inside"].data_ptr(),
            mesh_outside=scene["mesh_mat_outside"].data_ptr(),
            mesh_vascular=scene["mesh_is_vascular"].data_ptr(), n_mesh=n_mesh,
            spacing=spacing.data_ptr(),
            from_=b["from"].data_ptr(), to=b["to"].data_ptr(), direction=b["direction"].data_ptr(),
            reflected=b["reflected"].data_ptr(), initial=b["initial"].data_ptr(),
            attenuation=b["attenuation"].data_ptr(), distance=b["distance"].data_ptr(),
            media_id=b["media_id"].data_ptr(), valid=b["valid"].data_ptr(),
            outside=b["outside"].data_ptr(), query=b["query"].data_ptr(),
            eps=cfg.intensity_epsilon, eps_floor=cfg.intensity_epsilon * 1e-3,
            frequency=cfg.transducer_frequency, ray_start_offset=cfg.ray_start_offset,
            speed_of_sound=cfg.speed_of_sound, max_travel_time_us=cfg.max_travel_time_us,
            bug_compat_material_transition=int(cfg.bug_compat_material_transition),
            cull_time_window=int(cfg.cull_time_window), n=n, depth=0, first=1,
        )

    def _launch(self) -> None:
        _build.launch("mcray_bounce", ctypes.byref(self.args), device=self.buffers["query"].device)

    def _write(self, d: int, row: dict) -> None:
        for k, v in row.items():
            self.raw[k][d].copy_(v)

    def start_plain(self, positions, directions, materials, spacing) -> dict:
        """Row 0 by the plain version."""
        state = initial_state(positions, directions, self.local_samples, self.starting_material,
                              self.cfg)
        return row_of(state, rays_plain(state, materials, spacing, self.cfg))

    def start(self, positions, directions, materials, spacing) -> None:
        if not self.card:
            return self._write(0, self.start_plain(positions, directions, materials, spacing))
        self.args.first = 1
        self._launch()

    def bounce_plain(self, d: int, row: dict, hits: dict, materials, spacing) -> tuple:
        """Bounce ``d`` from its ``row`` by the plain version: the segment's
        ``to`` and ``reflected``, and row d + 1."""
        draws = {k: v[d] for k, v in self.draws.items()}
        segment, nxt = bounce_plain(hits, draws, state_of(row), row_as_query(row), materials,
                                    thickness_by_mesh(materials, self.scene), self.scene,
                                    spacing, self.cfg)
        return segment["to"], segment["reflected"], row_of(nxt, rays_plain(nxt, materials,
                                                                           spacing, self.cfg))

    def bounce(self, d: int, row: dict, hits: dict, materials, spacing) -> None:
        if not self.card:
            to, reflected, nxt = self.bounce_plain(d, row, hits, materials, spacing)
            self._write(d, {"to": to, "reflected": reflected})
            return self._write(d + 1, nxt)
        self.hits = self._point_to_hits(self.args, hits)  # held until the launch has read them
        self.args.depth, self.args.first = d, 0
        self._launch()

    def _point_to_hits(self, args: _Args, hits: dict) -> tuple:
        """Check a bounce's closest hit and point ``args`` at it; returns the
        tensors pointed into."""
        n = self.args.n
        hit, point = hits["hit"].contiguous(), hits["point"].contiguous()
        normal, mesh_id = hits["normal"].contiguous(), hits["mesh_id"].contiguous()
        _build.require(hit, "hit", torch.bool, (n,))
        _build.require(point, "point", torch.float32, (n, 3))
        _build.require(normal, "normal", torch.float32, (n, 3))
        _build.require(mesh_id, "mesh_id", torch.int32, (n,))
        args.hit, args.point = hit.data_ptr(), point.data_ptr()
        args.normal, args.mesh_id = normal.data_ptr(), mesh_id.data_ptr()
        return hit, point, normal, mesh_id

    def start_backward(self, inputs, grads: dict, want_pose: bool, want_table: bool) -> dict:
        """Row 0's backward from the gradients ``grads`` of its ``GRADED_ROW``
        fields: the gradients of ``positions`` and ``directions``
        (``want_pose``) and of the table (``want_table``), by the backward
        kernel's first mode on the card, ``start_adjoint_plain`` on the CPU."""
        positions, directions, materials, spacing = inputs
        if not self.card:
            state = initial_state(positions, directions, self.local_samples,
                                  self.starting_material, self.cfg)
            return start_adjoint_plain(state, self.local_samples, materials, spacing, self.cfg,
                                       grads, want_table, want_pose)
        r = positions.shape[0]
        args, out, held = self._bwd_args(0, True, grads, want_table)
        if want_pose:
            out["positions"], out["directions"] = self._empty((r, 3)), self._empty((r, 3))
            held.append(self._empty((2, self.args.n, 3)))
            args.path_grads = held[-1].data_ptr()
            args.d_positions = out["positions"].data_ptr()
            args.d_directions = out["directions"].data_ptr()
            args.n_elements = r
        self._launch_bwd(args)
        return out

    def bounce_backward(self, d: int, row: dict, hits: dict, materials, spacing, grads: dict,
                        want: set) -> dict:
        """Bounce ``d``'s backward from ``grads`` (the gradients of segment
        d's ``to`` and ``reflected`` and, under ``next``, of row d + 1's
        ``GRADED_ROW`` fields; None for zero): the gradients of row d's
        ``GRADED_ROW`` fields but ``query``, of the hits' ``point`` and
        ``normal`` and of the table (``materials``), those of ``want``, by
        one launch of the backward kernel on the card, ``bounce_adjoint_plain``
        on the CPU."""
        if not self.card:
            draws = {k: v[d] for k, v in self.draws.items()}
            return bounce_adjoint_plain(state_of(row), hits, draws, row["attenuation"], row["to"],
                                        materials, self.scene, spacing, self.cfg, grads,
                                        "materials" in want)
        n = self.args.n
        args, out, held = self._bwd_args(d, False, {**grads["next"], "to_end": grads["to"],
                                                    "reflected": grads["reflected"]},
                                         "materials" in want)
        held += self._point_to_hits(args.fwd, hits)
        for k in ("from", "direction", "initial", "distance", "attenuation", "to", "point",
                  "normal"):
            if k in want:
                out[k] = self._empty((n,) if k in ("initial", "distance", "attenuation")
                                     else (n, 3))
                setattr(args, f"d_{k}", out[k].data_ptr())
        self._launch_bwd(args)
        return out

    def _empty(self, shape):
        return torch.empty(shape, dtype=torch.float32, device=self.buffers["query"].device)

    def _bwd_args(self, d: int, first: bool, grads: dict, want_table: bool):
        """A backward launch's arguments: the forward's, at bounce ``d`` (or
        row 0, ``first``), with the incoming gradients ``grads`` (``to_end``
        the segment's end, ``to`` the row's far end; None: zero) and, for
        ``want_table``, the table's gradient (in the returned outputs) and its
        partial sums. Returns the arguments, the outputs and the tensors the
        arguments point into."""
        n, m = self.args.n, self.inputs[2].shape[0]
        args = _BwdArgs(fwd=_Args.from_buffer_copy(self.args))
        args.fwd.depth, args.fwd.first = d, int(first)
        out, held = {}, []
        shapes = {"to_end": (n, 3), "reflected": (n,), "from": (n, 3), "direction": (n, 3),
                  "initial": (n,), "distance": (n,), "attenuation": (n,), "to": (n, 3),
                  "query": (2, n, 3)}
        fields = {"to_end": "g_to", "to": "g_far"}
        for k, shape in shapes.items():
            if grads.get(k) is None:
                continue
            g = grads[k].contiguous()
            _build.require(g, f"gradient of {k}", torch.float32, shape)
            held.append(g)
            setattr(args, fields.get(k, f"g_{k}"), g.data_ptr())
        if want_table:
            out["materials"] = self._empty((m, 8))
            held.append(torch.empty((-(-n // BWD_BLOCK), m, 4), dtype=torch.float64,
                                    device=out["materials"].device))
            args.d_materials, args.partials = out["materials"].data_ptr(), held[-1].data_ptr()
        return args, out, held

    def _launch_bwd(self, args) -> None:
        _build.launch("mcray_bounce_bwd", ctypes.byref(args), device=self.buffers["query"].device)


def _no_spacing_grad(need: bool) -> None:
    if need:
        raise ValueError("the bounce physics' backward gives no gradient of spacing")


class _Start(torch.autograd.Function):
    """Row 0 from the elements: its ``GRADED_ROW`` fields, views of the
    record. Its backward is the backward kernel's first mode on the card,
    ``start_adjoint_plain`` on the CPU."""

    @staticmethod
    def forward(ctx, record, positions, directions, materials, spacing):
        ctx.set_materialize_grads(False)
        record.start(positions, directions, materials, spacing)
        ctx.record = record
        ctx.save_for_backward(positions, directions, materials, spacing)
        row = record.row(0)
        ctx.mark_non_differentiable(row["initial"], row["distance"])
        return tuple(row[k] for k in GRADED_ROW)

    @staticmethod
    def backward(ctx, *grads):
        _, need_pos, need_dir, need_table, need_spacing = ctx.needs_input_grad
        _no_spacing_grad(need_spacing)
        got = ctx.record.start_backward(ctx.saved_tensors, dict(zip(GRADED_ROW, grads)),
                                        want_pose=need_pos or need_dir, want_table=need_table)
        return (None, got.get("positions") if need_pos else None,
                got.get("directions") if need_dir else None, got.get("materials"), None)


class _Bounce(torch.autograd.Function):
    """Bounce d after its closest hit: segment d's ``to`` and ``reflected``,
    then row d + 1's ``GRADED_ROW`` fields, views of the record. ``to``
    (row d's far end, an input) is the one field a launch writes over:
    its value only enters ``where(hit, inside point, far end)``, so its
    gradient is the segment end's where the path did not hit, whatever the
    row holds after the launch. The backward is one launch of the backward
    kernel on the card, ``bounce_adjoint_plain`` on the CPU."""

    @staticmethod
    def forward(ctx, record, d, ints, hit, mesh_id, *tensors):
        ctx.set_materialize_grads(False)
        *graded, point, normal, materials, spacing = tensors
        row = {**dict(zip(GRADED_ROW, graded)), **ints}
        record.bounce(d, row, {"hit": hit, "point": point, "normal": normal, "mesh_id": mesh_id},
                      materials, spacing)
        ctx.record, ctx.d, ctx.ints = record, d, ints
        ctx.save_for_backward(hit, mesh_id, *tensors)
        nxt = record.row(d + 1)
        return (record.buffers["to"][d], record.buffers["reflected"][d],
                *(nxt[k] for k in GRADED_ROW))

    @staticmethod
    def backward(ctx, *grads):
        hit, mesh_id, *tensors = ctx.saved_tensors
        *graded, point, normal, materials, spacing = tensors
        need = ctx.needs_input_grad[5:]
        _no_spacing_grad(need[-1])
        row = {**dict(zip(GRADED_ROW, graded)), **ctx.ints}
        hits = {"hit": hit, "point": point, "normal": normal, "mesh_id": mesh_id}
        g = {"to": grads[0], "reflected": grads[1], "next": dict(zip(GRADED_ROW, grads[2:]))}
        names = (*GRADED_ROW, "point", "normal", "materials")
        want = {k for k, w in zip(names, need) if w}
        got = ctx.record.bounce_backward(ctx.d, row, hits, materials, spacing, g, want)
        return (None,) * 5 + tuple(got.get(k) if k in want else None for k in names) + (None,)


class Bounces:
    """The D bounces of one trace around its closest hits. ``query`` is
    the current bounce's ray, ``(origin, seg_vec)`` (N, 3) each; ``step(hits)``
    runs the bounce after its closest hit and sets up the next query;
    ``segments()`` returns the (D, N, ...) segment fields and
    ``final_state()`` the path state after the last step (the state a bounce
    D would start from).

    The paths start at their elements (``initial_state``). The record lives
    in (D + 1, N, ...) buffers that each launch fills a row of: one launch
    writes row 0 here, each ``step`` one more. ``segments()`` returns views of
    rows [0, D), or, where a gradient is recorded, the launches' rows
    stacked (the same values, each with its launch's backward)."""

    def __init__(self, positions, directions, local_samples: int, draws: dict, materials,
                 scene: dict, spacing, starting_material: int, cfg: SimConfig):
        self.cfg, self.d = cfg, 0
        self.materials, self.spacing = materials, spacing
        self.record = _Record(positions, directions, local_samples, draws, materials, scene,
                              spacing, starting_material, cfg)
        graded = _Start.apply(self.record, positions, directions, materials, spacing)
        self.rows = [{**self.record.row(0), **dict(zip(GRADED_ROW, graded))}]

    @property
    def query(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The current bounce's closest-hit query (origin, seg_vec), (N, 3) each."""
        query = self.rows[self.d]["query"]
        return query[0], query[1]

    def step(self, hits: dict) -> None:
        """The current bounce after its closest hit ``hits`` (``hit``,
        ``point``, ``normal``, ``mesh_id``); then the next bounce's query."""
        d = self.d
        if d >= self.cfg.max_depth:
            raise ValueError(f"all {self.cfg.max_depth} bounces have run")
        row = self.rows[d]
        ints = {k: row[k] for k in ("media_id", "outside", "valid")}
        out = _Bounce.apply(self.record, d, ints, hits["hit"], hits["mesh_id"],
                            *(row[k] for k in GRADED_ROW), hits["point"], hits["normal"],
                            self.materials, self.spacing)
        row["to"], row["reflected"] = out[0], out[1]
        self.rows.append({**self.record.row(d + 1), **dict(zip(GRADED_ROW, out[2:]))})
        self.d += 1

    def segments(self) -> dict[str, torch.Tensor]:
        """The (D, N, ...) segment fields (``rays`` (D, 6, N)), once every
        bounce has run."""
        d = self.cfg.max_depth
        if self.d != d:
            raise ValueError(f"{self.d} of {d} bounces have run")
        rows = self.rows[:d]
        graded = any(r[k].requires_grad for r in rows for k in (*GRADED_ROW, "reflected"))
        out = {}
        for k in (*SEGMENT_FIELDS[:-1], "query"):
            stack = graded and k not in ("media_id", "valid")
            out[k] = torch.stack([r[k] for r in rows]) if stack else self.record.buffers[k][:d]
        # (D, 2, N, 3) -> (D, 6, N): [origin; segment] as the closest hit takes its rays
        out["rays"] = out.pop("query").transpose(2, 3).reshape(d, 6, -1)
        return out

    def final_state(self) -> dict[str, torch.Tensor]:
        """The path state after the last step, by ``STATE_FIELDS``."""
        return state_of(self.rows[self.d])
