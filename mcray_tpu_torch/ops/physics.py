"""Acoustic ray physics: boundary interaction, attenuation, sampling.

Port of ``mcray_tpu/ops/physics.py:35-381`` as vectorised torch over
``(N,)`` ray batches. Materials are rows of an ``(M, 8)`` float32 table.

Randomness: ``draw_bounce_randoms`` derives one frame's five ``(D, N)`` fields
from the per-path keys by the reference's own key chain (``utils/rng.py``,
threefry), so the uniforms are the reference's bit for bit and the normal
agrees to ``erfinv``'s rounding.

Deliberate divergences from the C++ that the reference already documents
are kept: total internal reflection contributes only the reflection
factor (no NaN), and the non-vascular media transition replicates the
reference's pointer-comparison bug only under
``cfg.bug_compat_material_transition`` (src/ray.cpp:44).
"""

from __future__ import annotations

import math

import torch

from ..config import SimConfig
from ..utils import rng
from .geometry import dot3, normalize

# Material table column indices (loader.MATERIAL_FIELDS order, src/mesh.h:7-10).
IMPEDANCE, ATTENUATION, MU0, MU1, SIGMA, SPECULARITY, SHININESS, THICKNESS = range(8)


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with ids clamped to [0, M-1] (jnp gather semantics), in
    f32: a double copy of an f32 table gives the same rows, and autograd then
    sums their gradient into the table in double."""
    m = table.shape[0]
    flat = ids.reshape(-1).long().clamp(0, m - 1)
    return table.index_select(0, flat).reshape(ids.shape + table.shape[1:]).float()


def safe_pow(base: torch.Tensor, exponent: torch.Tensor) -> torch.Tensor:
    """max(base, 0)^exponent with 0^e = 0."""
    ok = base > 0.0
    return torch.where(ok, torch.pow(torch.where(ok, base, 1.0), exponent), 0.0)


def max_ray_length(intensity, attenuation, frequency: float, eps: float):
    """Attenuation-bounded ray length (src/ray.cpp:110-113, including its
    multiply-by-frequency quirk)."""
    # a tensor numerator: torch evaluates ``float / tensor`` as a reciprocal
    # times the float, one rounding more than the reference's division
    return 10.0 * torch.log(torch.full_like(intensity, eps) / intensity) / -attenuation * frequency


def travel_attenuation(attenuation, distance_mm, frequency: float):
    """Beer-Lambert intensity factor for a travelled span (src/ray.cpp:99-103)."""
    return torch.exp(-attenuation * distance_mm * 0.01 * frequency)


def snells_law(direction, normal, incidence, refraction, ratio):
    """Vector-form Snell (src/ray.cpp:115-124)."""
    return ratio[..., None] * direction + (ratio * incidence - refraction)[..., None] * normal


def reflection_intensity(intensity, z1, incidence, z2, refraction):
    """I * ((Z1 c1 - Z2 c2) / (Z1 c1 + Z2 c2))^2 (src/ray.cpp:126-132)."""
    num = z1 * incidence - z2 * refraction
    denom = z1 * incidence + z2 * refraction
    return intensity * torch.square(num / denom)


def reflected_intensity_mattausch(direction, refr_dir, refl_dir, spec_hit, tir):
    """Mattausch Eq. 8 backscatter (src/ray.cpp:154-164); under TIR the
    refraction term is dropped instead of the reference's NaN."""
    refr_term = torch.where(tir, 0.0, safe_pow(dot3(direction, refr_dir), spec_hit))
    return refr_term + safe_pow(dot3(direction, refl_dir), spec_hit)


def draw_bounce_randoms(path_keys: torch.Tensor, n_depth: int) -> dict[str, torch.Tensor]:
    """One frame's random draws, each (n_depth, N) on the keys' device, from
    the (N, 2) per-path keys: the sub-surface fuzz normal, the power-cosine
    uniform (clamped to >= 1e-12), the unit-vector disc uniforms and the
    roulette uniform.

    The key chain is the reference's (``physics.py:160-190``):
    ``fold_in(path_key, depth)`` -> ``split(2)`` -> [normal key, rest];
    ``split(rest, 3)`` -> [power-cosine key, unit-vector key, roulette key];
    ``split(unit-vector key, 2)`` -> the two disc keys. It runs batched over
    (depth, path): four key derivations and one draw of the five fields'
    bits, five cipher passes in all."""
    depths = torch.arange(n_depth, dtype=torch.int64, device=path_keys.device)
    ks = rng.split(rng.fold_in(path_keys[None], depths[:, None]), 2)   # (D, N, 2, 2)
    ks2 = rng.split(ks[:, :, 1], 3)                                    # (D, N, 3, 2)
    rks = rng.split(ks2[:, :, 1], 2)                                   # (D, N, 2, 2)
    # one pass for all five fields: [normal, angle, axis, radius, roulette]
    keys = torch.stack([ks[:, :, 0], ks2[:, :, 0], rks[:, :, 0], rks[:, :, 1], ks2[:, :, 2]])
    u = rng.uniform(keys)                                              # (5, D, N) in [0, 1)
    return {
        "q_normal": rng.normal_from_uniform(u[0]),
        "angle_u": torch.clamp(u[1], min=1e-12),
        "axis_u": u[2],
        "radius_u": u[3],
        "roulette_u": u[4],
    }


def random_unit_vector_parts(u_a, u_r, v, cos_theta) -> dict:
    """``random_unit_vector_from_uniforms`` (``w``) with the intermediates
    its hand-derived adjoint reads (``ops/cuda/bounce.py``)."""
    a = u_a * (2.0 * math.pi)
    r = 0.5 * torch.sqrt(u_r)
    px0 = r * torch.cos(a)
    py0 = r * torch.sin(a)
    p = torch.clamp(px0 * px0 + py0 * py0, min=1e-12)

    vx0, vy0, vz = v[..., 0], v[..., 1], v[..., 2]
    flag = torch.abs(vx0) > torch.abs(vy0)
    vx = torch.where(flag, vy0, vx0)
    vy = torch.where(flag, vx0, vy0)

    b0 = 1.0 - vx * vx
    b = torch.clamp(b0, min=1e-12)
    x0 = (1.0 - cos_theta * cos_theta) / (p * b)
    c = torch.sqrt(torch.clamp(x0, min=1e-20))
    px = px0 * c
    py = py0 * c
    d = cos_theta - vx * px
    wx = vx * cos_theta - b * px
    wy = vy * d + vz * py
    wz = vz * d - vy * py
    w = torch.stack([torch.where(flag, wy, wx), torch.where(flag, wx, wy), wz], dim=-1)
    return {"w": w, "px0": px0, "py0": py0, "p": p, "flag": flag, "vx": vx, "vy": vy, "vz": vz,
            "b0": b0, "b": b, "x0": x0, "c": c, "px": px, "py": py, "d": d}


def random_unit_vector_from_uniforms(u_a, u_r, v, cos_theta):
    """Random vector at polar angle arccos(cos_theta) around ``v``: the
    reference's disc sampling and component swap (src/ray.cpp:167-211)."""
    return random_unit_vector_parts(u_a, u_r, v, cos_theta)["w"]


def material_transition(media_id, media_outside_id, mesh_vascular, mesh_mat_inside,
                        mesh_mat_outside, cfg: SimConfig):
    """The vascular in/out media state machine (src/ray.cpp:14-47) on integer
    material ids (-1 == "not inside a vessel"). Returns
    (material_after_collision, media_outside_after) for the refracted branch."""
    in_vessel = media_outside_id >= 0
    none = torch.full_like(media_id, -1)
    # in vessel, hit a vessel -> leave it; hit an organ -> flip stored tissue
    m1, o1 = media_outside_id, none
    o2 = torch.where(media_outside_id == mesh_mat_inside, mesh_mat_outside, mesh_mat_inside)
    m2 = media_id
    # outside, hit a vessel -> enter it, remember current tissue
    m3, o3 = mesh_mat_inside, media_id
    if cfg.bug_compat_material_transition:
        m4 = mesh_mat_inside
    else:
        m4 = torch.where(media_id == mesh_mat_inside, mesh_mat_outside, mesh_mat_inside)
    o4 = none
    mat_after = torch.where(
        in_vessel, torch.where(mesh_vascular, m1, m2), torch.where(mesh_vascular, m3, m4)
    )
    out_after = torch.where(
        in_vessel, torch.where(mesh_vascular, o1, o2), torch.where(mesh_vascular, o3, o4)
    )
    return mat_after, out_after


def hit_boundary(
    direction,          # (N, 3) unit
    hit_point,          # (N, 3)
    surface_normal,     # (N, 3) oriented toward the ray origin side
    intensity,          # (N,) intensity after travel to the boundary
    media_id,           # (N,) i32
    media_outside_id,   # (N,) i32, -1 = none
    mesh_id,            # (N,) i32 collided mesh
    materials,          # (M, 8) f32
    mesh_mat_inside,
    mesh_mat_outside,
    mesh_is_vascular,
    cfg: SimConfig,
    draws: dict[str, torch.Tensor],
    parts: bool = False,
):
    """Vectorised boundary interaction (src/ray.cpp:11-97) for one bounce;
    ``draws`` holds this bounce's (N,) slices of ``draw_bounce_randoms``.

    Returns back_intensity and the continued ray's new_direction,
    new_media_id, new_media_outside_id, new_intensity, chose_reflection and,
    with ``parts``, the intermediates a hand-derived adjoint recomputes from
    (``ops/cuda/bounce.py:bounce_adjoint_plain``)."""
    mesh_id_c = mesh_id.clamp(min=0).long()  # missed rays are masked upstream
    m_in = mesh_mat_inside.index_select(0, mesh_id_c).int()
    m_out = mesh_mat_outside.index_select(0, mesh_id_c).int()
    vascular = mesh_is_vascular.index_select(0, mesh_id_c)
    mat_after, out_after = material_transition(
        media_id, media_outside_id, vascular, m_in, m_out, cfg
    )

    rows_media = take_rows(materials, media_id)
    rows_after = take_rows(materials, mat_after)
    exponent = 1.0 / (torch.floor(rows_after[:, SHININESS]) + 1.0)
    random_angle = torch.pow(draws["angle_u"], exponent)
    random_normal = random_unit_vector_from_uniforms(
        draws["axis_u"], draws["radius_u"], surface_normal, random_angle
    )

    # incidence = |d . n| via the reference's flip-if-negative (src/ray.cpp:53-57)
    incidence = torch.abs(dot3(direction, random_normal))
    z1 = rows_media[:, IMPEDANCE]
    z2 = rows_after[:, IMPEDANCE]
    ratio = z1 / z2
    refr_sq = 1.0 - ratio * ratio * (1.0 - incidence * incidence)
    tir = refr_sq < 0.0
    # double where: sqrt's gradient at 0 is inf, which would turn the masked
    # total-internal-reflection lanes' gradients into inf * 0 = NaN, and the
    # lanes where refr_sq is exactly 0 (a grazing ray at a boundary of equal
    # impedances, or at the critical angle) into inf in the material table:
    # both take the value 0 with a zero gradient
    refracts = refr_sq > 0.0
    refr_angle = torch.where(refracts, torch.sqrt(torch.where(refracts, refr_sq, 1.0)), 0.0)

    refr_dir = normalize(
        snells_law(direction, random_normal, incidence, refr_angle, ratio), eps=1e-20
    )
    refl_dir = normalize(direction + 2.0 * incidence[..., None] * random_normal, eps=1e-20)

    i_refl = torch.where(
        tir, intensity, reflection_intensity(intensity, z1, incidence, z2, refr_angle)
    )
    i_refr = intensity - i_refl
    back = reflected_intensity_mattausch(
        direction, refr_dir, refl_dir, rows_after[:, SPECULARITY], tir
    ) * random_angle

    # Russian roulette: continue with ONE of reflection/refraction (src/ray.cpp:85-94)
    eps = cfg.intensity_epsilon
    reflect = (i_refl / torch.clamp(intensity, min=eps)) > draws["roulette_u"]
    refl_int = torch.where(i_refl > eps, i_refl, 0.0)
    refr_int = torch.where(i_refr > eps, i_refr, 0.0)
    out = {
        "back_intensity": back,
        "new_from": hit_point,
        "new_direction": torch.where(reflect[..., None], refl_dir, refr_dir),
        "new_media_id": torch.where(reflect, media_id, mat_after),
        "new_media_outside_id": torch.where(reflect, media_outside_id, out_after),
        "new_intensity": torch.where(reflect, refl_int, refr_int),
        "chose_reflection": reflect,
    }
    if parts:
        out.update(mat_after=mat_after, random_angle=random_angle, random_normal=random_normal,
                   incidence=incidence, z1=z1, z2=z2, ratio=ratio, refr_angle=refr_angle,
                   refracts=refracts, tir=tir, refr_dir=refr_dir, refl_dir=refl_dir,
                   i_refl=i_refl, i_refr=i_refr, spec=rows_after[:, SPECULARITY])
    return out
