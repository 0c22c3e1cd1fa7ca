"""End-to-end ultrasound simulator: trace -> march -> RF image -> B-mode.

Port of ``mcray_tpu/models/simulator.py`` (reference src/main.cpp:92-152 and
scene::cast_rays, src/scene.cpp:50-183), differentiable in the material
table (``models/trainer.py`` fits it):

- the ragged per-ray segment lists are a dense ``(D, N)`` segment dict with
  a validity mask (N = elements x samples paths);
- the bounce loop runs D bounces over the whole path batch, each through
  one closest-hit kernel: on scenes of 2,048 triangles and up the
  reference's default, the list-driven cluster kernel (K5; on request K6
  culled, K7 staged, or K10 grouped with its residual K5 pass), else the
  brute kernel (K1); ``use_bvh`` (``render --bvh``) walks the flat BVH
  instead (K11, which no TPU kernel carries in the reference);
- the march (K2), PSF convolution + envelope (K3) and scan conversion (K4)
  run as one kernel each; under autograd the march and the scan conversion
  run their backward kernels (K8, K9), the closest hit has no gradient (it
  makes the discrete choice; the winner's t is recomputed in plain torch).
  Where the reference leaves its kernels for jnp, the port runs plain
  torch on the same device: ``soft_row_binning`` takes the scatter march
  (``march_and_accumulate``), the centered PSF and the Hilbert envelope
  the plain postproc (``mcray_tpu/models/simulator.py:384-397``).

Every stage calls its kernel's wrapper, which launches the CUDA kernel for
CUDA tensors and runs the plain PyTorch version for CPU tensors; the
``Simulator``'s ``device`` decides which, and it is the card unless the
caller asks for the CPU.

Randomness is explicit and keyed (``utils/rng.py``, threefry): ``render``
takes the frame's draws (``physics.draw_bounce_randoms``) and the two
texture seeds, and ``Simulator`` derives both from integer seeds by the
reference's key chain, so one seed gives the reference's frame.

A batch of frames is one pass, as the reference's ``vmap`` is one call
(``render_frames``): B frames, each with its own draws and pose, trace as
B x N paths (one closest-hit launch per bounce), march into one (rf_rows,
B x E) image (one K2 launch; column b E + e is frame b's element e), and
run K3 and K4 once over the (B, rows, cols) stack, whose kernels take the
frame as their grid's second axis. ``render`` is its batch of one.
"""

from __future__ import annotations

import functools

import torch

from ..config import SimConfig, validate
from ..ops import clusters, imaging, physics, texture
from ..ops.bvh import DeviceBVH
from ..ops.cuda import _build, add_launch_counts, launch_counts
from ..ops.cuda.bvh_intersect import bvh_intersect_closest_cuda
from ..ops.cuda.intersect import intersect_closest_cuda
from ..ops.cuda.intersect_culled import intersect_closest_culled
from ..ops.cuda.intersect_grouped import intersect_closest_grouped
from ..ops.cuda.intersect_listed import intersect_closest_listed
from ..ops.cuda.intersect_staged import intersect_closest_staged
from ..ops.cuda.march import march_cuda, pack_segments
from ..ops.cuda.postproc import kernel_modes, postproc_cuda
from ..ops.cuda.scanconv import scan_convert_cuda, scan_maps
from ..ops.geometry import safe_norm
from ..ops.texture import fdiv
from ..probe.transducer import element_layout
from ..utils import convert, profiling, rng

#: the cluster closest hits by intersect_mode
CLUSTER_INTERSECTS = {
    "listed": intersect_closest_listed,
    "culled": intersect_closest_culled,
    "staged": intersect_closest_staged,
    "grouped": intersect_closest_grouped,
}


def cluster_intersect(mode: str, tile_r: int):
    """The closest hit of ``mode`` on ``tile_r``-ray packets (for grouped,
    the packets of its residual listed pass)."""
    key = "residual_tile_r" if mode == "grouped" else "tile_r"
    return functools.partial(CLUSTER_INTERSECTS[mode], **{key: tile_r})


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no card present
    raises instead of carrying on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} (the default) needs a CUDA device and none is "
            'available; pass device="cpu" to run the plain PyTorch versions on the CPU')
    return device


def distance_in_mm(a, b, spacing):
    """World distance with per-axis spacing, x10 to mm (src/scene.cpp:281-290)."""
    return safe_norm(torch.abs(a - b) * spacing) * 10.0


def trace_paths(draws, materials, probe_position, probe_angles_deg, scene, spacing,
                starting_material: int, cfg: SimConfig, *, culled_tris=None,
                intersect_tile_r: int = 128, sort_packets: bool = False,
                bvh: DeviceBVH | None = None, elements=None) -> dict[str, torch.Tensor]:
    """Monte-Carlo path tracing of all elements x samples paths. Returns the
    segment dict, each field stacked over bounce depth (D, N, ...), plus
    ``rays``: the (D, 6, N) [origin; segment] closest-hit queries of every
    bounce, as the intersect kernel received them.

    ``probe_position`` and ``probe_angles_deg`` are one pose (3,) or B poses
    (B, 3): B frames trace together as N = B x E x S paths, frame-major
    (frame b's paths, and its ``draws``, are columns [b E S, (b+1) E S)), and
    each path's ``element`` is its column b E + e of the (rf_rows, B E) image.

    ``culled_tris=(packed, mode)`` runs the closest hit through the cluster
    kernel of ``mode`` (``CLUSTER_INTERSECTS``) on ``intersect_tile_r``-ray
    packets, coherence-sorted first if ``sort_packets``; else ``bvh`` (the
    scene's ``DeviceBVH``) runs the BVH traversal; with neither, the brute
    kernel runs over ``scene["tri_soa"]``.

    ``elements=(positions (R_local, 3), directions (R_local, 3), elem_idx
    (N_local,))`` replaces the element batch for sharded execution, as the
    reference's ``elements`` does (``mcray_tpu/models/simulator.py:79-100``):
    ``elem_idx`` is each path's local RF column, and the paths of an element
    are consecutive. The reference's fourth entry, the global path ids, keys
    the draws here: ``draws`` are ``path_draws(key, cfg, device, path_ids)``."""
    n_samples = cfg.samples_per_element
    freq = cfg.transducer_frequency
    eps = cfg.intensity_epsilon
    profiling.mark("bounce_physics", (probe_position if elements is None else elements[0]).device)
    if elements is None:
        positions, directions = element_layout(probe_position, probe_angles_deg, cfg)
        elem_idx = torch.arange(positions.shape[0], dtype=torch.int32,
                                device=positions.device).repeat_interleave(n_samples)
    else:
        positions, directions, elem_idx = elements
    device = positions.device
    n = elem_idx.shape[0]
    # paths per element in this batch (fewer than n_samples where the samples are sharded)
    local_samples = n // positions.shape[0]

    tri_soa, tri_mesh_id = scene["tri_soa"], scene["tri_mesh_id"]
    mesh_in, mesh_out = scene["mesh_mat_inside"], scene["mesh_mat_outside"]
    mesh_vasc = scene["mesh_is_vascular"]
    # per-mesh inside thickness, so the per-ray lookup is one small gather
    thick_by_mesh = physics.take_rows(materials, mesh_in)[:, physics.THICKNESS]

    src = positions.repeat_interleave(local_samples, dim=0)
    direction = directions.repeat_interleave(local_samples, dim=0)
    media_id = torch.full((n,), starting_material, dtype=torch.int32, device=device)
    media_outside_id = torch.full((n,), -1, dtype=torch.int32, device=device)
    intensity = torch.full((n,), cfg.initial_intensity / n_samples, dtype=torch.float32,
                           device=device)
    distance_mm = torch.zeros((n,), dtype=torch.float32, device=device)
    alive = torch.ones((n,), dtype=torch.bool, device=device)

    if culled_tris is not None:
        packed, mode = culled_tris
        cluster_fn = cluster_intersect(mode, intersect_tile_r)

    segments = []
    for d in range(cfg.max_depth):
        bounce_draws = {k: v[d] for k, v in draws.items()}
        att = physics.take_rows(materials[:, physics.ATTENUATION], media_id)
        r_length = physics.max_ray_length(torch.clamp(intensity, min=eps * 1e-3), att, freq, eps)
        origin = src + cfg.ray_start_offset * direction
        # enlarge(): mm/100 with per-axis spacing (src/scene.cpp:292-298).
        # r_length is detached: it only sets the ray's reach (hit or no hit);
        # the hit point does not move with the segment's scale, so its
        # analytic gradient is zero, but in f32 it is a cancellation of huge
        # log(eps/I)/att^2 terms that would pour noise into the material
        # gradients (as the reference, models/simulator.py:136-143)
        dest = src + fdiv(r_length.detach()[:, None], 100.0) * spacing * direction
        # dead rays get a zero segment parked far away: det == 0, so they miss
        alive_col = alive[:, None]
        seg_vec = (dest - origin) * alive_col
        origin = torch.where(alive_col, origin, 1e9)

        # the listed closest hit marks where its prepass ends; the other
        # modes are one stage
        listed = culled_tris is not None and mode == "listed"
        profiling.mark("prepass" if listed else "closest_hit", device)
        if culled_tris is None and bvh is not None:
            hits = bvh_intersect_closest_cuda(origin, seg_vec, tri_soa, tri_mesh_id, bvh)
        elif culled_tris is None:
            hits = intersect_closest_cuda(origin, seg_vec, tri_soa, tri_mesh_id)
        elif sort_packets:
            hits = clusters.intersect_sorted(cluster_fn, origin, seg_vec, packed)
        else:
            hits = cluster_fn(origin, seg_vec, packed)
        profiling.mark("bounce_physics", device)
        hit = hits["hit"] & alive

        # sub-surface penetration fuzz: q ~ |N(0, thickness_inside)| (src/scene.cpp:129-139)
        thick = physics.take_rows(thick_by_mesh, hits["mesh_id"].clamp(min=0))
        q = torch.abs(bounce_draws["q_normal"] * thick)
        inside_point = hits["point"] + q[:, None] * direction

        dist_mm = distance_in_mm(src, inside_point, spacing)
        intensity_travelled = intensity * physics.travel_attenuation(att, dist_mm, freq)
        hb = physics.hit_boundary(
            direction, hits["point"], hits["normal"], intensity_travelled,
            media_id, media_outside_id, hits["mesh_id"], materials,
            mesh_in, mesh_out, mesh_vasc, cfg, draws=bounce_draws,
        )
        miss = alive & ~hits["hit"]
        segments.append({
            "from": src,
            "to": torch.where(hit[:, None], inside_point, dest),
            "direction": direction,
            "reflected": torch.where(hit, hb["back_intensity"], 0.0),
            "initial": intensity,
            "attenuation": att,
            "distance": distance_mm,
            "media_id": media_id,
            "valid": hit | miss,
            "rays": torch.cat([origin, seg_vec], dim=1).T,
        })

        alive_next = hit & (hb["new_intensity"] > eps)
        if cfg.cull_time_window:
            # the continuation's segment would start at t0 >= the window: none
            # of its echoes can land in the RF image
            t0_next = fdiv((distance_mm + dist_mm) * 1000.0, cfg.speed_of_sound)
            alive_next = alive_next & (t0_next < float(cfg.max_travel_time_us))
        src = torch.where(hit[:, None], hb["new_from"], src)
        direction = torch.where(hit[:, None], hb["new_direction"], direction)
        media_id = torch.where(hit, hb["new_media_id"], media_id)
        media_outside_id = torch.where(hit, hb["new_media_outside_id"], media_outside_id)
        intensity = torch.where(hit, hb["new_intensity"], intensity)
        distance_mm = torch.where(hit, distance_mm + dist_mm, distance_mm)
        alive = alive_next

    out = {k: torch.stack([s[k] for s in segments]) for k in segments[0]}
    out["element"] = elem_idx.expand(cfg.max_depth, n)
    return out


def segment_march_quantities(segments, materials, cfg: SimConfig):
    """Derived quantities of the march loop, shared by the scatter march and
    the kernel packing: steps (float), start time t0 [us], ln attenuation
    per step, and the segment material's mu0, mu1, sigma."""
    axres = cfg.axial_resolution_mm
    # scene::distance ignores spacing (src/scene.cpp:342-346)
    seg_len = safe_norm(segments["to"] - segments["from"]) * 10.0
    steps = torch.floor(fdiv(seg_len, axres))
    t0 = fdiv(segments["distance"] * 1000.0, cfg.speed_of_sound)
    ln_att_step = -segments["attenuation"] * axres * 0.01 * cfg.transducer_frequency
    rows = physics.take_rows(materials, segments["media_id"])
    return steps, t0, ln_att_step, rows[..., physics.MU0], rows[..., physics.MU1], rows[..., physics.SIGMA]


def march_and_accumulate(segments, materials, volume, cfg: SimConfig, n_cols: int | None = None):
    """Segment marching + echo scatter-add (reference main loop,
    src/main.cpp:106-141) as one masked dense (segments x steps) grid: the
    reference's own plain march, which the kernel path is held against."""
    d, n = segments["valid"].shape
    flat = {k: v.reshape((d * n,) + v.shape[2:]) for k, v in segments.items() if k != "rays"}
    axres = cfg.axial_resolution_mm
    dt = cfg.march_dt_us

    steps_f, t0, ln_att_step, mu0, mu1, sigma = segment_march_quantities(flat, materials, cfg)
    steps = steps_f.int()
    k = torch.arange(cfg.max_march_steps, dtype=torch.float32, device=t0.device)[None, :]
    t_k = t0[:, None] + k * dt
    live = (k < steps[:, None]) & (t_k < float(cfg.max_travel_time_us)) & flat["valid"][:, None]
    points = flat["from"][:, None, :] + (k * axres)[..., None] * flat["direction"][:, None, :]
    intens = flat["initial"][:, None] * torch.exp(ln_att_step[:, None] * k)
    scat = texture.get_scattering(volume, mu1[:, None], mu0[:, None], sigma[:, None], points, cfg)
    cols = flat["element"][:, None].expand(t_k.shape)

    # boundary echo at t0 + dt*(steps-1); steps == 0 would underflow to a
    # dropped row in the reference (unsigned wrap, src/main.cpp:139)
    b_time = t0 + dt * (steps.float() - 1.0)
    b_valid = flat["valid"] & (steps >= 1)
    b_vals = fdiv(flat["reflected"], float(cfg.samples_per_element))

    all_times = torch.cat([t_k.reshape(-1), b_time])
    all_cols = torch.cat([cols.reshape(-1), flat["element"]])
    all_vals = torch.cat([(intens * scat).reshape(-1), b_vals])
    all_valid = torch.cat([live.reshape(-1), b_valid])
    if cfg.soft_row_binning:  # d(RF)/d(time) flows: the two-row split
        return imaging.accumulate_echoes_soft(all_times, all_cols, all_vals, all_valid, cfg, n_cols)
    return imaging.accumulate_echoes(imaging.time_to_row(all_times, cfg), all_cols, all_vals,
                                     all_valid, cfg, n_cols)


def path_draws(trace_key: torch.Tensor, cfg: SimConfig, device,
               path_ids: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """The (D, N) draws of ``physics.draw_bounce_randoms`` for the paths
    ``path_ids`` (default: every path of the frame, 0..N-1), each keyed
    ``fold_in(trace_key, global path id)`` (``trace_paths``' keying in the
    reference, ``mcray_tpu/models/simulator.py:91-100``): a shard draws for
    its own paths only, and exactly what the whole frame draws for them.
    ``trace_key`` (B, 2), one trace key per frame, gives B frames' draws in
    one pass, (D, B x N) frame-major: what B calls give, side by side."""
    if path_ids is None:
        path_ids = torch.arange(cfg.transducer_elements * cfg.samples_per_element,
                                dtype=torch.int64, device=device)
    path_keys = rng.fold_in(trace_key.to(device)[..., None, :], path_ids.to(device))
    return physics.draw_bounce_randoms(path_keys.reshape(-1, 2), cfg.max_depth)


def march_segments(segments, materials, seeds, volume, cfg: SimConfig, n_cols: int):
    """The (rf_rows, n_cols) RF image of ``segments`` (each path's column is
    its ``element``) and the packed SoA the march kernel read: K2 on the
    SoA, or under ``soft_row_binning`` the reference's plain scatter march
    (its kernel bins hard), with no SoA (None)."""
    profiling.mark("march", segments["valid"].device)
    if cfg.soft_row_binning:
        return None, march_and_accumulate(segments, materials, volume or {"seeds": seeds}, cfg,
                                          n_cols)
    soa = pack_segments(segments, materials, cfg, n_cols)
    return soa, march_cuda(soa, seeds, cfg, n_cols)


def scan_convert_frame(rf_env, maps, cfg: SimConfig):
    """Log compression where ``cfg`` asks for it (over the whole image: its
    maximum is global; each frame's own for a (B, rows, cols) stack), then
    the scan conversion clamped at 0, as the reference clamps on its kernel
    path (simulator.py:407-420). Returns (rf_env, bmode)."""
    if cfg.log_compression:
        rf_env = imaging.log_compress(rf_env)
    return rf_env, torch.clamp(scan_convert_cuda(rf_env, maps), min=0.0)


#: the keys of ``render_frames`` that carry the frame axis
FRAME_KEYS = ("bmode", "rf_raw", "rf_conv", "rf_env", "segments_valid")


def render_frames(draws, seeds, materials, positions, angles, scene, spacing,
                  starting_material: int, maps, cfg: SimConfig, volume=None,
                  **trace_kw) -> dict[str, torch.Tensor]:
    """B frames in one pass, each from its own randomness and pose: the
    reference's ``vmap`` of ``render`` over frames
    (``mcray_tpu/models/simulator.py:617-621``). ``positions`` and
    ``angles`` are (B, 3); ``draws`` are the (D, B x N) fields of
    ``physics.draw_bounce_randoms``, frame-major (``path_draws`` of the B
    trace keys); the texture ``seeds``, ``materials`` and the rest are
    shared, as in ``render``.

    Every stage runs once for the B frames: the closest hit on B x N rays a
    bounce, K2 on the (rf_rows, B E) image whose column b E + e is frame b's
    element e (then laid out as (B, rf_rows, E): a permuted copy), K3 and
    K4 over the (B, ...) stacks. Frame b equals ``render`` of its own draws
    and pose. Returns ``render``'s keys with a leading B: ``bmode`` (B,
    bmode_rows, bmode_cols), ``rf_raw``, ``rf_conv``, ``rf_env`` (B, rf_rows,
    rf_cols), ``segments_valid`` (B, D, N); and ``segments`` (D, B x N) and
    ``soa`` (of the wide image) as the march took them."""
    b = positions.shape[0]
    segments = trace_paths(draws, materials, positions, angles, scene, spacing,
                           starting_material, cfg, **trace_kw)
    soa, rf_wide = march_segments(segments, materials, seeds, volume, cfg, b * cfg.rf_cols)
    rf_raw = rf_wide.reshape(cfg.rf_rows, b, cfg.rf_cols).transpose(0, 1).contiguous()
    profiling.mark("image", rf_raw.device)
    rf_env = postproc_cuda(rf_raw, cfg)
    fused = rf_raw.device.type == "cuda" and kernel_modes(cfg)
    rf_conv = rf_raw if fused else imaging.convolve_psf(rf_raw, cfg)
    rf_env, bmode = scan_convert_frame(rf_env, maps, cfg)
    valid = segments["valid"]
    return {"bmode": bmode, "rf_raw": rf_raw, "rf_conv": rf_conv, "rf_env": rf_env,
            "segments_valid": valid.reshape(valid.shape[0], b, -1).transpose(0, 1),
            "soa": soa, "segments": segments}


def render(draws, seeds, materials, probe_position, probe_angles_deg, scene, spacing,
           starting_material: int, maps, cfg: SimConfig, volume=None,
           **trace_kw) -> dict[str, torch.Tensor]:
    """Full frame from explicit randomness: ``draws`` (the (D, N) fields of
    ``physics.draw_bounce_randoms``) and the (2,) texture ``seeds``;
    ``maps`` are the scan conversion's ``ScanMaps``; ``volume`` is the
    texture volume of ``seeds`` where it holds tables ("table" mode: the
    scatter march gathers from them, the kernels evaluate the hash);
    ``trace_kw`` (the closest-hit choice) go to ``trace_paths``. If
    ``materials`` requires grad, ``bmode`` is attached to it. The batch of
    one of ``render_frames``: the same launches, one of each stage.

    Returns the reference's keys (``mcray_tpu/models/simulator.py:422-429``):
    ``bmode`` (bmode_rows, bmode_cols), ``rf_raw``, ``rf_conv``, ``rf_env``
    and ``segments_valid`` (D, N); and the intermediates the stages pass on:
    ``segments`` (with the per-bounce ``rays``) and the packed ``soa`` (None
    under ``soft_row_binning``). ``rf_conv`` is as on the reference's two
    paths: where K3 runs (a CUDA image, the uncentered PSF and the reference
    envelope) it fuses the convolution into the envelope and ``rf_conv`` is
    ``rf_raw``, as on the reference's fused-kernel path; where the plain
    postproc runs (the CPU, the centered PSF, the Hilbert envelope) it is
    ``imaging.convolve_psf(rf_raw)``."""
    out = render_frames(draws, seeds, materials, probe_position[None], probe_angles_deg[None],
                        scene, spacing, starting_material, maps, cfg, volume, **trace_kw)
    frame = {k: v[0] if k in FRAME_KEYS else v for k, v in out.items()}
    if out["rf_conv"] is out["rf_raw"]:  # K3 fused the convolution: one image, as there
        frame["rf_conv"] = frame["rf_raw"]
    return frame


class Simulator:
    """A compiled scene and config bound to a device.

    ``device="cuda"`` (the default) runs every stage through the CUDA
    kernels, ``"cpu"`` through their plain versions; nothing else differs.
    Without a card the default raises: the CPU is used only when asked for.

    The closest hit follows the reference's defaults
    (``mcray_tpu/models/simulator.py:436-519``): scenes of 2,048 triangles
    and up (``use_culled_intersect=None``) pack BVH-ordered triangle clusters
    and run ``intersect_mode`` (default ``"listed"``; ``"culled"``,
    ``"staged"`` and ``"grouped"`` on request) on ``intersect_tile_r``-ray
    packets (default 512; 128 for the brute kernel), with 128-triangle
    clusters for listed and grouped and 256 for culled and staged.
    ``"grouped"`` visits each cluster once with the rays that reach it (K10):
    the mode for large scenes whose rays are incoherent, where a packet's
    cluster list approaches the whole table; coherent rays overflow into its
    residual listed pass (K5 on ``intersect_tile_r``-ray packets), so it is
    exact at every depth. The reference takes these defaults only on a TPU;
    the port takes them on every device, because the CPU runs the plain
    versions of the same kernels. An unknown mode raises ValueError.
    ``use_bvh=True`` walks the pack's flat BVH (K11) where the pack has one,
    and is not replaced by the cluster path unless ``use_culled_intersect``
    asks for it (``mcray_tpu/models/simulator.py:453``, ``:477-482``, ``:510``).

    The randomness is the reference's: the texture seeds come from the key
    ``prng_key(seed ^ 0x5CA77E7)`` (derived on the CPU: the kernels read
    them on the host), and a frame's draws from ``prng_key(frame seed)``
    through ``fold_in(key, 0)`` and ``fold_in(., path id)`` over the global
    path ids, on ``device``. ``render_frame(seed)`` therefore renders the
    frame the reference renders for ``seed`` (``normal`` to ``erfinv``'s
    rounding); ``render_frame(draws=...)`` takes fixed draws, for a fit.
    """

    def __init__(self, pack, cfg: SimConfig, *, device="cuda", seed: int = 0,
                 use_bvh: bool = False, use_culled_intersect: bool | None = None,
                 intersect_mode: str | None = None,
                 intersect_tile_r: int | None = None, sort_packets: bool = False):
        validate(cfg)
        intersect_mode = intersect_mode or "listed"
        if intersect_mode not in CLUSTER_INTERSECTS:
            raise ValueError(f"unknown intersect_mode {intersect_mode!r}; expected one of "
                             f"{tuple(CLUSTER_INTERSECTS)}")
        self.cfg = cfg
        self.pack = pack
        self.device = resolve_device(device)
        volume = texture.make_texture_volume(rng.prng_key(seed ^ 0x5CA77E7), cfg,
                                             device=self.device)
        state = convert.from_reference(pack, pack.materials, volume["seeds"], device=self.device)
        # the texture tables ("table" mode; the seeds alone otherwise)
        self.volume = volume if "noise" in volume else None
        self.scene = state["scene"]
        self.materials = state["materials"]
        self.spacing = state["spacing"]
        self.starting_material = state["starting_material"]
        self.position = state["position"]
        self.angles = state["angles"]
        self.seeds = state["seeds"]
        self.scan_maps = scan_maps(*imaging.scan_conversion_maps(cfg), cfg.rf_rows, cfg.rf_cols,
                                   device=self.device)

        bvh = getattr(pack, "bvh", None)
        use_bvh = use_bvh and bvh is not None
        if use_culled_intersect is None:
            use_culled_intersect = not use_bvh and pack.n_triangles >= 2048
        self.culled_tris = None
        if use_culled_intersect and pack.n_triangles > 0:
            packed = clusters.pack_tris_culled(
                pack.tris, pack.tri_mesh_id, bvh.tri_order if bvh is not None else None,
                sort_origin=pack.transducer_position,
                tile_t=128 if intersect_mode in ("listed", "grouped") else clusters.TILE_T,
                device=self.device,
            )
            self.culled_tris = (packed, intersect_mode)
            use_bvh = False
        self.bvh = DeviceBVH.from_flat(bvh, self.scene["tri_soa"]) if use_bvh else None
        if intersect_tile_r is None:
            intersect_tile_r = 512 if self.culled_tris is not None else 128
        self.intersect_tile_r = intersect_tile_r
        self.sort_packets = sort_packets

    @property
    def trace_kw(self) -> dict:
        """The closest-hit choice, as ``render``/``trace_paths`` take it."""
        return {"culled_tris": self.culled_tris, "intersect_tile_r": self.intersect_tile_r,
                "sort_packets": self.sort_packets, "bvh": self.bvh}

    @property
    def intersect(self) -> str:
        """The closest hit the frame runs: a cluster mode, ``"bvh"`` or ``"brute"``."""
        if self.culled_tris is not None:
            return self.culled_tris[1]
        return "bvh" if self.bvh is not None else "brute"

    def _tensor(self, x, default):
        return default if x is None else torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @staticmethod
    def _frame_keys(seeds) -> torch.Tensor:
        """The (B, 2) keys of ``seeds``: integer frame seeds or (2,) keys (on
        the CPU), or a (B, 2) tensor of keys (``rng.split``'s, left on its
        device: the chained batch's, derived on the card, copy nothing)."""
        if isinstance(seeds, torch.Tensor):
            return seeds.reshape(-1, 2)
        return torch.stack([(s if isinstance(s, torch.Tensor) else rng.prng_key(s)).cpu()
                            for s in seeds])

    def draws(self, seed) -> dict[str, torch.Tensor]:
        """The frame's random draws on the device, keyed as the reference
        keys them: ``seed`` is the frame's integer seed or its (2,) key."""
        return self.batch_draws([seed])

    def batch_draws(self, seeds) -> dict[str, torch.Tensor]:
        """The (D, B x N) draws of B frames (``seeds`` as ``render_frames``
        takes them) in one pass: frame b's are columns [b N, (b+1) N),
        bitwise ``draws(seeds[b])``."""
        # the frames' trace keys are B keys: derived on the host, not by ~150 launches
        return path_draws(rng.fold_in(self._frame_keys(seeds), 0), self.cfg, self.device)

    def render_frame(self, seed=0, materials=None, position=None, angles=None, draws=None):
        """One frame; returns the dict of ``render``. ``seed`` is an integer
        or a (2,) key; ``draws`` replaces the draws of ``seed`` (fixed
        randomness for a fit)."""
        return render(
            self.draws(seed) if draws is None else draws, self.seeds,
            self._tensor(materials, self.materials),
            self._tensor(position, self.position),
            self._tensor(angles, self.angles),
            self.scene, self.spacing, self.starting_material, self.scan_maps, self.cfg,
            volume=self.volume, **self.trace_kw,
        )

    def render_frames(self, seeds, materials=None, positions=None, angles=None):
        """B frames in one batched pass (``render_frames``); returns its dict.
        ``seeds`` are integer frame seeds, (2,) keys, or a (B, 2) tensor of
        keys (``rng.split``'s); ``positions`` and ``angles``
        are one pose (3,) for every frame (the scene's by default) or one per
        frame (B, 3). Frame b is ``render_frame(seeds[b], materials,
        positions[b], angles[b])``, bitwise on the card."""
        keys = self._frame_keys(seeds)
        b = keys.shape[0]

        def per_frame(x, default):
            return self._tensor(x, default).expand(b, 3)

        return render_frames(
            self.batch_draws(keys), self.seeds, self._tensor(materials, self.materials),
            per_frame(positions, self.position), per_frame(angles, self.angles),
            self.scene, self.spacing, self.starting_material, self.scan_maps, self.cfg,
            volume=self.volume, **self.trace_kw,
        )

    def render_batch(self, seeds, materials=None, position=None, angles=None) -> torch.Tensor:
        """(B, H, W) B-modes of independent Monte-Carlo frames, one per seed,
        in one batched pass at one pose (the reference's ``render_batch``:
        many frames in one device call)."""
        return self.render_frames(seeds, materials, position, angles)["bmode"]

    def render_compound(self, seeds, **kw) -> torch.Tensor:
        """Speckle-compounded B-mode: the mean of independent frames, one
        batched pass (``render_batch``)."""
        return self.render_batch(seeds, **kw).mean(dim=0)

    def make_chained_batch(self, batch: int, n_chain: int):
        """``fn(seed0) -> (batch, H, W)``: ``n_chain`` steps of ``batch``
        frames in one call, the B-modes of the last step (the reference's
        ``make_chained_batch``, ``mcray_tpu/models/simulator.py:642-679``).
        See ``ChainedBatch``."""
        return ChainedBatch(self, batch, n_chain)

    @property
    def rays_per_frame(self) -> int:
        """Traced path-bounce queries per frame (src/scene.cpp:75-117)."""
        return self.cfg.transducer_elements * self.cfg.samples_per_element * self.cfg.max_depth


class ChainedBatch:
    """``n_chain`` steps of ``batch`` frames from one seed, keyed as the
    reference's ``make_chained_batch`` keys them: with ``key =
    prng_key(seed0)``, step i renders the frames of the keys ``fold_in(key,
    carry + i * batch + b)`` (b < batch, uint32), each as
    ``Simulator.render_frames`` renders a frame of its key (draws from
    ``fold_in(key, 0)``, the scene's pose and materials), and then adds
    ``uint32(|bmode[0, 0, 0]| * 1e-30)`` to ``carry`` (0 for any finite
    image: a data-dependent chain, as there). A call returns the last step's
    (batch, H, W) B-modes.

    On the card one step (the keys, the draws, ``render_frames``, the carry)
    is captured as a CUDA graph at the first call, after one eager step on a
    side stream that builds the kernels and fills the caches the step reads;
    the graph has a memory pool of its own (the whole chain as one graph
    replays no faster and takes longer to capture: ``PERF.md``, the chained
    batch). A call writes ``seed0``'s key into the graph's key buffer, sets
    ``i`` and ``carry`` (device buffers that each step advances) to 0, and
    replays the graph ``n_chain`` times, so no host value enters between
    steps. The returned tensor is the graph's output buffer: the next call
    overwrites it. The graph reads the ``Simulator``'s tensors as they are at capture
    (a later assignment to ``materials`` or the pose is not seen). A
    capture or replay that fails raises; nothing runs the steps eagerly on
    the card after that. The kernels' launch counters
    (``ops.cuda.launch_counts``) count what ran on the card: the warm-up
    step, then each replay the captured step's launches (``launches``, by
    kernel); the capture itself counts none.

    The step carries the stage marks (``utils/profiling.py:mark``) into the
    graph, so a profiled replay splits by stage. A call is the span
    ``chained.call`` (a request id of its own; ``units``: its frames), each
    replay a child span ``chained.replay``, and the first call's warm-up and
    capture the span ``chained.capture``. The counters
    ``chained.graph_nodes`` and ``chained.graph_frames`` (the step graph's
    nodes and frames, once at capture) count what a replay hides.

    On the CPU the same step runs ``n_chain`` times, one after another, and
    a call returns a tensor of its own.
    """

    def __init__(self, sim: Simulator, batch: int, n_chain: int):
        if batch < 1 or n_chain < 1:
            raise ValueError(f"batch {batch} and n_chain {n_chain} must be positive")
        self.sim, self.batch, self.n_chain = sim, batch, n_chain
        device = sim.device
        self.key = torch.zeros(2, dtype=torch.int64, device=device)
        self.i = torch.zeros((), dtype=torch.int64, device=device)
        self.carry = torch.zeros((), dtype=torch.int64, device=device)
        self.offsets = torch.arange(batch, dtype=torch.int64, device=device)
        self.graph = None
        self.out = None
        #: the captured step's kernel launches, by kernel (``launch_counts``' names)
        self.launches = {}

    def step_keys(self) -> torch.Tensor:
        """The (batch, 2) frame keys of the next step: ``fold_in(key, carry +
        i * batch + b)`` in uint32."""
        return rng.fold_in(self.key, self.carry + self.i * self.batch + self.offsets)

    def step(self) -> torch.Tensor:
        """One step on the buffers: the next step's frames, then ``carry``
        and ``i`` advanced. Returns the (batch, H, W) B-modes."""
        with torch.no_grad():
            profiling.mark("draws", self.sim.device)
            bmode = self.sim.render_frames(self.step_keys())["bmode"]
            dep = (bmode[0, 0, 0].abs() * 1e-30).to(torch.int64)
            self.carry.copy_((self.carry + dep) & rng._MASK32)
            self.i.add_(1)
        return bmode

    def capture(self) -> None:
        """One eager step on a side stream, then one step captured into
        ``graph`` (its own memory pool), both in the span
        ``chained.capture``; counts the graph's nodes and the step's
        launches. The kernel library is loaded first, outside the span (a
        checkout's first run builds it)."""
        device = self.sim.device
        _build.library()
        with profiling.span("chained.capture", units=self.batch):
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                self.step()
            torch.cuda.current_stream(device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            before = launch_counts()
            with torch.cuda.graph(graph):
                out = self.step()
                nodes = profiling.capture_nodes(device)
            torch.cuda.synchronize(device)
        self.launches = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
        add_launch_counts(self.launches, -1)  # captured, not run
        profiling.count("chained.graph_nodes", nodes)
        profiling.count("chained.graph_frames", self.batch)
        self.graph, self.out = graph, out

    def __call__(self, seed0: int) -> torch.Tensor:
        with profiling.span("chained.call", request=profiling.request(),
                            units=self.batch * self.n_chain):
            return self._call(seed0)

    def _call(self, seed0: int) -> torch.Tensor:
        if self.sim.device.type == "cuda" and self.graph is None:
            self.capture()
        self.key.copy_(rng.prng_key(seed0))
        self.i.zero_()
        self.carry.zero_()
        if self.graph is None:  # the CPU
            for _ in range(self.n_chain):
                out = self.step()
            return out
        for _ in range(self.n_chain):
            with profiling.span("chained.replay", units=self.batch):
                self.graph.replay()
        add_launch_counts(self.launches, self.n_chain)
        return self.out
