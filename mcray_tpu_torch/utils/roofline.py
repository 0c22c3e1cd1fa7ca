"""Roofline accounting on one NVIDIA H100: the operations and bytes a piece
of work needs, set against the card's peaks, so that a measured time turns
into a share of the least time the card could take.

Port of ``mcray_tpu/utils/roofline.py`` (and of ``scripts/roofline.py``'s
``stage_table``). The peaks are the H100 SXM data sheet's: 3.35 TB/s of
device memory and 67 TFLOP/s of plain f32 outside the tensor cores, which
is what every kernel and stage here computes in (no kernel uses the tensor
cores, so the bf16 rate has no use here). The data sheet's rates assume the
card's full 700 W power limit; a card may be set below it and then runs
slower under load, so every share is printed beside ``nvidia_smi()``'s name
and power limit.

Two kinds of floor, each counting each input byte read once, each output
byte written once, and the operations the inputs need (where the work
depends on the data, what this run's data needs):

- per kernel (``*_bound``; ``march_cost`` and the other stage costs'
  ``floor()``): the least time for the kernel's own algorithm on the
  launch's inputs, which says how far a kernel is from what it sets out to
  do. The brute, cluster, grouped and BVH closest hits count different work
  on the same rays: each answers for its own algorithm.
- per stage of a frame (``frame_costs``): the least work the stage's
  function needs, the same whatever kernel runs it. Its closest hit is the
  reference BVH walk's work (``bvh_best_plain``), the least any of the
  port's closest hits needs for those rays. This departs on purpose from
  the reference's ``intersect_cost``, which counted its prepass and its TPU
  tiles: a prepass (the listed and grouped modes' dense rays x clusters
  slab tests) is part of a stage's time, not of its floor.

Operations are counted per unit of work from the formulas in the sources
(a transcendental as one operation): the ``OPS_*`` constants below.
``StageCost.summarize`` gives the reference's keys for a stage's time, and
``stage_table`` times a frame's five stages on the card by the profiler's
busy time (``utils/benchmarking.py``). The reference counts the TPU
formulation (the envelope's log-step scans, the scan conversion's one-hot
matmuls), so its operation counts differ from these; its bytes of the
postproc are the same.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import ClassVar

import torch

from ..models import simulator
from ..ops import clusters, imaging
from ..ops.bvh import DeviceBVH, bvh_best_plain
from ..ops.cuda import launch_counts, reset_launch_counts
from ..ops.cuda.march import F_STEPS, F_T0, F_VALID, pack_segments
from ..ops.cuda.postproc import kernel_modes, postproc_cuda
from .benchmarking import busy_view, event_ms

# the card's published peaks (H100 SXM data sheet): device memory and plain
# f32 outside the tensor cores, which is what every kernel here computes in
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# operation counts per unit of work, from the formulas in the sources
OPS_MOLLER_TRUMBORE = 50          # per ray-triangle test (2 cross, 4 dot, 1 div, compares)
OPS_HASH_PAIR = 40                # two lowbias32 hashes + two bitsum normals of one voxel
OPS_MARCH_STEP = {False: OPS_HASH_PAIR + 30,            # nearest: index, gate, exp, accumulate
                  True: 8 * (OPS_HASH_PAIR + 12) + 60}   # trilinear: 8 corners + weights
OPS_MARCH_BWD_STEP = {False: OPS_HASH_PAIR + 60, True: 8 * (OPS_HASH_PAIR + 36) + 120}
OPS_POSTPROC_CELL = 2 * (7 + 13) + 10   # the two tap sums + the envelope lerp
OPS_SCANCONV_PIXEL = 11                 # 4 weight products, 4 multiplies, 3 adds
OPS_SLAB_NODE = 26                      # per node popped: 6 sub, 6 mul, 10 min/max, 4 compares
# threefry2x32 (utils/rng.py), per block cipher call on uint32 words: 20
# rounds of add, rotate (shift, shift, or) and xor, and the key added at the
# start (2) and after every fourth round (two words and the round count, x 5)
OPS_THREEFRY = 20 * 5 + 2 + 5 * 3
OPS_UNIFORM = 3                   # the bits to a float in [0, 1): shift, or, subtract
OPS_NORMAL = 35                   # scale to (-1, 1), erfinv's polynomial, x sqrt(2)
# cipher calls per path-bounce of physics.draw_bounce_randoms: fold_in of the
# depth (1), split into 2, 3 and 2 keys (7), one uniform of five fields (5)
CIPHERS_PER_BOUNCE = 13
DRAW_FIELDS = 5
# the trace's physics per live path-bounce, beside its closest hit: the
# segment's reach and ends (~30: a log, a divide, 3-vector sums), the hit
# record (~32: point, normal, oriented), the sub-surface fuzz and the
# distance (~23: a sqrt), the travel attenuation (~6: an exp), the boundary
# (~160: the material transition, a pow, the random unit vector's cos, sin
# and sqrt, Snell's law and two normalisations, the Fresnel and Mattausch
# terms, the roulette) and the path's state updates (~19)
OPS_BOUNCE = 270
# the bounce kernel (csrc/bounce.cu) per path-bounce: OPS_BOUNCE but the hit
# record (~32), which the closest hit's winner tail computes; and the bytes
# the bounce needs, each once: the state row (from, direction 24; initial,
# attenuation, distance, media 16; valid 1; outside 4), the hit record (hit 1,
# point and normal 24, mesh 4) and five draws (20) read; the segment's end
# (to 12, reflected 4), the next row's state (45) and its ray (origin and
# segment 24) written. The kernel writes the far end (12) too, which the hit
# replaces: a byte of the launch, not of the bounce
OPS_BOUNCE_KERNEL = OPS_BOUNCE - 32
BOUNCE_BYTES = 45 + 29 + 20 + 16 + 45 + 24
# the bounce's backward kernel (csrc/bounce.cu) per path-bounce: the bounce
# recomputed (OPS_BOUNCE_KERNEL) and its adjoint (~230: the next row's query,
# the roulette's choice, the two safe_pows with their pow and log, the Fresnel
# quotient, two normalisations, Snell, the power-cosine normal's ~30, the
# travel's and the distance's); and the bytes, each once: what the bounce
# reads (the state row 45, the hit record 29, five draws 20), the gradients
# reaching the launch (the segment's end and reflection 16, the next row's
# fields 48 and its ray 24) read, the row's fields and the hit's point and
# normal written (72)
OPS_BOUNCE_BWD = OPS_BOUNCE_KERNEL + 230
BOUNCE_BWD_BYTES = 45 + 29 + 20 + 16 + 48 + 24 + 72
# the segment fields the trace writes for the march, once per path-bounce
SEGMENT_FIELDS = ("from", "to", "direction", "reflected", "initial", "attenuation", "distance",
                  "media_id", "valid")
# each counted kernel (``ops.cuda.launch_counts``' names) and its device events' name
EVENT_NAMES = {"intersect": "intersect_closest_kernel",
               "intersect_listed": "intersect_listed_kernel",
               "intersect_culled": "intersect_culled_kernel",
               "intersect_staged": "intersect_staged_kernel",
               "intersect_grouped": "intersect_grouped_kernel",
               "bvh_intersect": "bvh4_quad_kernel",
               "march": "march_kernel", "postproc": "postproc_kernel",
               "scanconv": "scan_convert_kernel", "march_bwd": "march_bwd_kernel",
               "scanconv_bwd": "scanconv_bwd_kernel",
               # both kernels of csrc/draws.cu: the draws and the key batches
               "draws": "keyed_draws",
               # both instances of csrc/bounce.cu's kernel: row 0 and a bounce
               "bounce": "bounce_physics_kernel",
               # both kernels of a backward launch: the adjoint and its sums
               "bounce_bwd": "bounce_physics_bwd"}
STAGE_CALLS, FRAME_EVENTS = 3, 5  # calls a stage table profiles, frames it times by events


class Bound(tuple):
    """``(ms, by)``: the least time the card could take for ``n_bytes``
    moved and ``n_ops`` f32 operations, the larger of bytes over the memory
    rate and operations over the f32 rate, and which of the two (``"bytes"``
    or ``"operations"``) it is; the counts stay as attributes."""

    def __new__(cls, n_bytes: float, n_ops: float):
        by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
        by_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
        self = super().__new__(cls, (by_bytes, "bytes") if by_bytes >= by_ops
                               else (by_ops, "operations"))
        self.n_bytes, self.n_ops = n_bytes, n_ops
        return self


def bound(n_bytes: float, n_ops: float) -> Bound:
    """(bound_ms, bound_by) of ``n_bytes`` and ``n_ops``: ``Bound``."""
    return Bound(n_bytes, n_ops)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@dataclasses.dataclass
class StageCost:
    """A stage's work: ``flops`` f32 operations and ``hbm_bytes`` moved
    (each input read once, each output written once); ``useful_flops``,
    where given, the part of ``flops`` the problem needs whatever its
    formulation."""
    name: str
    flops: float
    hbm_bytes: float
    useful_flops: float | None = None
    unit: ClassVar[str] = "f32"

    def floor(self) -> Bound:
        return bound(self.hbm_bytes, self.flops)

    def summarize(self, seconds: float) -> dict:
        """The stage at ``seconds`` against the card's peaks, with the
        reference's keys (unrounded)."""
        eff_flops = self.flops / seconds
        eff_bw = self.hbm_bytes / seconds
        t_compute = self.flops / PEAK_F32_OPS_PER_S
        t_mem = self.hbm_bytes / PEAK_BYTES_PER_S
        row = {
            "stage": self.name,
            "ms": seconds * 1e3,
            "gflops": self.flops / 1e9,
            "hbm_mb": self.hbm_bytes / 1e6,
            "effective_tflops": eff_flops / 1e12,
            "pct_peak_compute": 100 * eff_flops / PEAK_F32_OPS_PER_S,
            "effective_gbps": eff_bw / 1e9,
            "pct_peak_hbm": 100 * eff_bw / PEAK_BYTES_PER_S,
            "bound": "compute" if t_compute >= t_mem else "bandwidth",
            "unit": self.unit,
            "roofline_ms": max(t_compute, t_mem) * 1e3,
        }
        if self.useful_flops is not None:
            row["useful_gflops"] = self.useful_flops / 1e9
            row["formulation_overhead_x"] = self.flops / max(self.useful_flops, 1.0)
        return row


# ---------------------------------------------------------------------------
# Per-kernel floors: each kernel's algorithm on a launch's inputs
# ---------------------------------------------------------------------------

def brute_bound(bounce_rays, tri_soa) -> Bound:
    """K1 per launch, mean over the bounces' (6, N) rays: every live ray (a
    parked dead ray has a zero segment and needs no test) against every
    triangle of the (9, T) ``tri_soa``."""
    n_b = n_o = 0
    for rays in bounce_rays:
        live = int((rays[3:6].abs().sum(dim=0) > 0).sum())
        n_b += nbytes(rays, tri_soa) + 8 * rays.shape[1]
        n_o += live * tri_soa.shape[1] * OPS_MOLLER_TRUMBORE
    return bound(n_b / len(bounce_rays), n_o / len(bounce_rays))


def cluster_bound(packed, launches) -> Bound:
    """A cluster kernel (K5, K6, K7) per launch, mean over ``launches``:
    [(padded rays (6, N), each ray's final t (N,), K5's packet lists or ())].
    Each live ray tested against the triangles of every cluster whose box it
    enters before its own final t (no closest hit in slot order can skip one
    of those); rows v0/e1/e2 and the box of every cluster some ray needs
    read once, the rays (and K5's lists) read once, t and slot written once."""
    n_b = n_o = 0
    for padded, best_t, lists in launches:
        o, s = padded[0:3].T, padded[3:6].T
        live = s.abs().sum(dim=1) > 0
        need = clusters.box_active(o[live][None], clusters.inverse_dirs(s[live])[None],
                                   packed.aabb_cluster, best_t[live][None])  # (clusters, rays)
        n_o += int(need.sum()) * packed.tile_t * OPS_MOLLER_TRUMBORE
        n_b += (nbytes(padded, *lists) + 8 * padded.shape[1]
                + int(need.any(dim=1).sum()) * (9 * packed.tile_t + 8) * 4)
    return bound(n_b / len(launches), n_o / len(launches))


def grouped_bound(launches) -> Bound:
    """K10 per launch, mean over ``launches`` (each its arguments: padded
    rays, ray tables, their counts, the packed clusters): every (ray,
    cluster) incidence in a table tested against the cluster's triangles;
    rows v0/e1/e2 of each cluster that holds a ray read once, the rays, the
    counts and the used table slots read once, and each ray's winner, (t,
    slot), written once."""
    n_b = n_o = 0
    for padded, _, counts, packed in launches:
        in_table = int(counts.sum())
        n_o += in_table * packed.tile_t * OPS_MOLLER_TRUMBORE
        n_b += (nbytes(padded, counts) + 4 * in_table + 8 * padded.shape[1]
                + int((counts > 0).sum()) * 9 * packed.tile_t * 4)
    return bound(n_b / len(launches), n_o / len(launches))


def reference_walks(rays: torch.Tensor, bvh: DeviceBVH) -> list:
    """The reference walk (``bvh_best_plain``) of each bounce's rays of a
    (D, 6, N) stack: [(rays (6, N), counts (2, N): nodes popped and
    triangles tested per ray, (nodes, triangles) touched masks)]."""
    walks = []
    for d in range(rays.shape[0]):
        q = rays[d].contiguous()
        _, _, counts, touched = bvh_best_plain(q, bvh, counts=True, touched=True)
        walks.append((q, counts, touched))
    return walks


def _walk_work(walks, bvh: DeviceBVH) -> tuple[int, int]:
    """(bytes, operations) of the reference walks, summed: every node each
    ray pops (its slab test) and every triangle it tests, by its counts; the
    rays read once, (t, winner) written once, and once each the distinct
    flat nodes (box, meta) and triangles (v0, e1, e2, scene index) that a
    walk's rays touch, by its masks."""
    node_bytes = nbytes(bvh.nodes[0], bvh.meta[0])
    tri_bytes = nbytes(bvh.tri_soa[:, 0], bvh.tri_order[0])
    n_b = n_o = 0
    for rays, counts, (seen_nodes, seen_tris) in walks:
        n_b += (nbytes(rays) + 8 * rays.shape[1] + int(seen_nodes.sum()) * node_bytes
                + int(seen_tris.sum()) * tri_bytes)
        n_o += int(counts[0].sum()) * OPS_SLAB_NODE + int(counts[1].sum()) * OPS_MOLLER_TRUMBORE
    return n_b, n_o


def bvh_bound(walks, bvh: DeviceBVH) -> Bound:
    """K11 per launch, mean over the bounces' ``walks`` (``reference_walks``):
    the work of the reference walk, whatever walk the kernel takes."""
    n_b, n_o = _walk_work(walks, bvh)
    return bound(n_b / len(walks), n_o / len(walks))


def bvh_touched(walks) -> dict[str, float]:
    """The distinct flat nodes and triangles a launch's rays touch in the
    reference walk, mean over the bounces."""
    nodes = sum(int(seen[0].sum()) for *_, seen in walks) / len(walks)
    tris = sum(int(seen[1].sum()) for *_, seen in walks) / len(walks)
    return {"nodes": nodes, "triangles": tris}


def matched_steps(soa: torch.Tensor, cfg, n_cols: int) -> int:
    """March steps of this SoA that land inside the time window: the work
    the march kernels need for these segments."""
    t0, steps = soa[:, F_T0, :n_cols], soa[:, F_STEPS, :n_cols]
    valid = soa[:, F_VALID, :n_cols] > 0.5
    in_window = torch.ceil((float(cfg.max_travel_time_us) - t0) / cfg.march_dt_us).clamp(min=0.0)
    return int((torch.minimum(steps, in_window) * valid).sum())


def march_cost(soa: torch.Tensor, cfg, n_cols: int) -> StageCost:
    """The march (K2) of a packed SoA into ``n_cols`` RF columns: the
    matched steps inside the window, the SoA read, the RF image written."""
    return StageCost("march", matched_steps(soa, cfg, n_cols) * OPS_MARCH_STEP[cfg.trilinear_texture],
                     nbytes(soa) + 4 * cfg.rf_rows * n_cols)


def march_bwd_cost(soa: torch.Tensor, cfg, n_cols: int) -> StageCost:
    """The march's VJP (K8): the matched steps; the SoA and the RF
    cotangent read, the SoA's gradient written."""
    return StageCost("march_bwd",
                     matched_steps(soa, cfg, n_cols) * OPS_MARCH_BWD_STEP[cfg.trilinear_texture],
                     2 * nbytes(soa) + 4 * cfg.rf_rows * n_cols)


def postproc_cost(cfg, frames: int = 1) -> StageCost:
    """The PSF convolution fused with the envelope (K3) over ``frames`` RF
    images: the image read, the envelope written (the reference's
    ``postproc_cost`` bytes)."""
    cells = frames * cfg.rf_rows * cfg.rf_cols
    return StageCost("postproc", cells * OPS_POSTPROC_CELL, 2 * 4 * cells)


def scanconv_cost(cfg, frames: int = 1) -> StageCost:
    """The scan conversion (K4) of ``frames`` images: a function of each
    image and the two f32 coordinate maps (bmode_rows, bmode_cols), each
    B-mode pixel a 4-tap bilinear lookup. The packed table the plain
    version reads is the port's own, larger, representation."""
    n_rf, n_bm = cfg.rf_rows * cfg.rf_cols, cfg.bmode_rows * cfg.bmode_cols
    return StageCost("scan_convert", frames * n_bm * OPS_SCANCONV_PIXEL,
                     4 * frames * n_rf + 2 * 4 * n_bm + 4 * frames * n_bm)


def scanconv_bwd_cost(cfg, taps: int, frames: int = 1) -> StageCost:
    """The transposed remap (K9) of ``frames`` B-mode cotangents over its
    ``taps`` (RF cell, pixel) weights: a multiply and an add a tap; the
    cotangents and the two maps read, the RF gradients written. The CSR
    lists the kernel reads are the port's own, larger, representation."""
    n_rf, n_bm = cfg.rf_rows * cfg.rf_cols, cfg.bmode_rows * cfg.bmode_cols
    return StageCost("scanconv_bwd", 2 * frames * taps,
                     4 * frames * n_bm + 2 * 4 * n_bm + 4 * frames * n_rf)


def copy_bound(tensor: torch.Tensor) -> Bound:
    """A copy of ``tensor`` into another layout: read once, written once."""
    return bound(2 * nbytes(tensor), 0)


# ---------------------------------------------------------------------------
# The stage floor of a frame
# ---------------------------------------------------------------------------

def draws_cost(cfg, frames: int = 1) -> StageCost:
    """The keyed draws of ``frames`` frames (``Simulator.batch_draws``): per
    path a ``fold_in`` of its id, per path-bounce CIPHERS_PER_BOUNCE cipher
    calls, OPS_THREEFRY each, and the five fields made floats (the normal by
    erfinv); the frames' keys read, the five (D, N) f32 fields written."""
    paths = frames * cfg.transducer_elements * cfg.samples_per_element
    draws = cfg.max_depth * paths
    ciphers = paths + CIPHERS_PER_BOUNCE * draws
    return StageCost("draws", ciphers * OPS_THREEFRY + DRAW_FIELDS * draws * OPS_UNIFORM
                     + draws * OPS_NORMAL, 2 * 8 * frames + DRAW_FIELDS * 4 * draws)


def bounce_cost(cfg, frames: int = 1) -> StageCost:
    """The bounce kernel's launches of a trace of ``frames`` frames, row 0
    left out: every path-bounce, live or not, OPS_BOUNCE_KERNEL operations
    and BOUNCE_BYTES bytes."""
    path_bounces = frames * cfg.transducer_elements * cfg.samples_per_element * cfg.max_depth
    return StageCost("bounce", path_bounces * OPS_BOUNCE_KERNEL, path_bounces * BOUNCE_BYTES)


def bounce_bwd_cost(cfg, frames: int = 1) -> StageCost:
    """The bounce backward kernel's launches of a trace of ``frames``
    frames, row 0's left out, counted as ``bounce_cost`` counts the
    forward's: every path-bounce, OPS_BOUNCE_BWD operations and
    BOUNCE_BWD_BYTES bytes."""
    path_bounces = frames * cfg.transducer_elements * cfg.samples_per_element * cfg.max_depth
    return StageCost("bounce_bwd", path_bounces * OPS_BOUNCE_BWD,
                     path_bounces * BOUNCE_BWD_BYTES)


def trace_cost(segments: dict, walks, bvh: DeviceBVH) -> StageCost:
    """The trace of a frame's (D, N) ``segments``: the closest hit of every
    bounce's rays as the reference walk does it (``_walk_work`` over
    ``walks``, whatever closest hit the frame ran), OPS_BOUNCE a live
    path-bounce for its physics, the draws read and the segment fields the
    march takes written once."""
    n_b, n_o = _walk_work(walks, bvh)
    valid = segments["valid"]
    return StageCost("trace", n_o + int(valid.sum()) * OPS_BOUNCE,
                     n_b + DRAW_FIELDS * 4 * valid.numel()
                     + nbytes(*(segments[k] for k in SEGMENT_FIELDS)))


def walks_match(walks, rays: torch.Tensor) -> bool:
    """Whether ``walks`` are of the bounces' (D, 6, N) ``rays``, bitwise."""
    return len(walks) == rays.shape[0] and all(
        torch.equal(w[0], rays[d]) for d, w in enumerate(walks))


def frame_costs(sim, out: dict, walks=None, bvh: DeviceBVH | None = None) -> dict[str, StageCost]:
    """The floor of each stage of a frame (or a batch) that ``sim`` rendered,
    ``out`` as ``render_frame`` or ``render_frames`` returns it: ``draws``,
    ``trace``, ``march``, ``postproc`` and ``scan_convert``, each a
    ``StageCost``. Counts only: it runs wherever ``sim`` does.

    The trace's closest hit is counted by the reference walk over the
    scene's BVH (``bvh``, default ``sim.bvh`` or the pack's), the same for
    every closest-hit mode given the same rays. ``walks`` are that walk's
    ``reference_walks`` of ``out``'s rays where the caller has them (they
    must be of those rays, bitwise); else they are walked here."""
    cfg = sim.cfg
    segments = out["segments"]
    frames = segments["valid"].shape[1] // (cfg.transducer_elements * cfg.samples_per_element)
    if bvh is None:
        bvh = sim.bvh
    if bvh is None:
        if getattr(sim.pack, "bvh", None) is None:
            raise ValueError("the trace's floor walks the scene's BVH: the pack has none")
        bvh = DeviceBVH(sim.pack.bvh, sim.scene["tri_soa"])
    if walks is None:
        walks = reference_walks(segments["rays"], bvh)
    elif not walks_match(walks, segments["rays"]):
        raise ValueError("the walks given are not of this frame's rays")
    n_cols = frames * cfg.rf_cols
    soa = out["soa"] if out["soa"] is not None else pack_segments(segments, sim.materials, cfg,
                                                                  n_cols)
    return {"draws": draws_cost(cfg, frames), "trace": trace_cost(segments, walks, bvh),
            "march": march_cost(soa, cfg, n_cols), "postproc": postproc_cost(cfg, frames),
            "scan_convert": scanconv_cost(cfg, frames)}


def _launches(fn):
    """``fn()``'s result and its kernel launches by device event name (the
    launch counts are set to 0 for it)."""
    reset_launch_counts()
    result = fn()
    torch.cuda.synchronize()
    return result, {EVENT_NAMES[k]: v for k, v in launch_counts().items() if v}


def stage_table(sim, seeds, walks=None, bvh: DeviceBVH | None = None) -> dict:
    """The roofline of the frame ``sim.render_frames(seeds)`` (one frame for
    one seed, a batch for more) on the card, stage by stage: each of the
    five stages of ``frame_costs`` called alone, as ``render_frames`` calls
    it, on the frame's own inputs, its time the device's busy ms by
    ``busy_view`` over STAGE_CALLS calls (each window holding every kernel
    launch of the stage); the frame's busy ms and operations over STAGE_CALLS
    frames, and its median over FRAME_EVENTS frames by events (which time
    the host too). The frame, then each stage, runs once first to warm up
    and to count its launches. ``walks`` and ``bvh`` go to ``frame_costs`` where the walks are
    of the frame's rays; else it walks them. The launch counts are left as
    the last stage set them.

    Returns the reference's summary keys (``stages``: ``summarize``'s rows,
    each with its floor's counts ``n_ops`` and ``n_bytes`` and the stage's
    device ``operations`` and kernel ``launches`` a call; ``full_frame_ms``,
    ``sum_stage_ms``, ``frame_gflops``, ``frame_hbm_mb``,
    ``frame_roofline_ms``, ``frame_pct_of_roofline``,
    ``frame_effective_gbps``), and ``frame_event_ms``, ``idle_share``,
    ``frame_operations``, ``frames``, ``triangles``, ``intersect``,
    ``walks_reused``. Needs the card; raises on a CPU ``Simulator``."""
    if sim.device.type != "cuda":
        raise RuntimeError("stage_table times the card: it needs a Simulator on a CUDA device")
    cfg = sim.cfg
    seeds = list(seeds)
    b = len(seeds)

    def frame():
        return sim.render_frames(seeds)

    out, frame_launches = _launches(frame)
    reuse = walks is not None and walks_match(walks, out["segments"]["rays"])
    costs = frame_costs(sim, out, walks if reuse else None, bvh)

    positions, angles = sim.position.expand(b, 3), sim.angles.expand(b, 3)
    draws = sim.batch_draws(seeds)
    segments, rf_raw = out["segments"], out["rf_raw"]

    def march():
        _, wide = simulator.march_segments(segments, sim.materials, sim.seeds, sim.volume, cfg,
                                           b * cfg.rf_cols)
        return wide.reshape(cfg.rf_rows, b, cfg.rf_cols).transpose(0, 1).contiguous()

    def postproc():
        rf_env = postproc_cuda(rf_raw, cfg)
        if not kernel_modes(cfg):  # K3 fuses the convolution only in its own modes
            imaging.convolve_psf(rf_raw, cfg)
        return rf_env

    rf_env = postproc()
    stages = {
        "draws": lambda: sim.batch_draws(seeds),
        "trace": lambda: simulator.trace_paths(draws, sim.materials, positions, angles, sim.scene,
                                               sim.spacing, sim.starting_material, cfg,
                                               **sim.trace_kw),
        "march": march,
        "postproc": postproc,
        "scan_convert": lambda: simulator.scan_convert_frame(rf_env, sim.scan_maps, cfg),
    }
    rows = []
    for name, fn in stages.items():
        _, expect = _launches(fn)
        view = busy_view(fn, STAGE_CALLS, expect=expect)
        rows.append({**costs[name].summarize(view["busy_ms"] / 1e3), "n_ops": costs[name].flops,
                     "n_bytes": costs[name].hbm_bytes, "operations": view["operations"],
                     "launches": expect})
    view = busy_view(frame, STAGE_CALLS, expect=frame_launches)
    frame_ms = statistics.median(event_ms(frame, FRAME_EVENTS))
    full_ms = view["busy_ms"]
    total_flops = sum(c.flops for c in costs.values())
    total_bytes = sum(c.hbm_bytes for c in costs.values())
    roofline_ms = sum(r["roofline_ms"] for r in rows)
    return {
        "frames": b, "triangles": sim.pack.n_triangles, "intersect": sim.intersect,
        "walks_reused": reuse,
        "stages": rows,
        "full_frame_ms": full_ms,
        "frame_event_ms": frame_ms,
        "idle_share": 1.0 - full_ms / frame_ms,
        "frame_operations": view["operations"],
        "sum_stage_ms": sum(r["ms"] for r in rows),
        "frame_gflops": total_flops / 1e9,
        "frame_hbm_mb": total_bytes / 1e6,
        "frame_roofline_ms": roofline_ms,
        "frame_pct_of_roofline": 100 * roofline_ms / full_ms,
        "frame_effective_gbps": total_bytes / (full_ms / 1e3) / 1e9,
    }


def to_markdown(table: dict, label: str) -> str:
    """``stage_table``'s result as a markdown table and a summary line."""
    lines = [f"{label} ({table['triangles']} triangles, intersect {table['intersect']}, "
             f"{table['frames']} frame(s)):", "",
             "| stage | busy ms | GFLOP | HBM MB | eff TFLOP/s | % peak f32 | eff GB/s | % HBM "
             "| bound | roofline ms | operations |",
             "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in table["stages"]:
        lines.append(f"| {r['stage']} | {r['ms']:.4f} | {r['gflops']:.5g} | {r['hbm_mb']:.5g} "
                     f"| {r['effective_tflops']:.4g} | {r['pct_peak_compute']:.4g}% "
                     f"| {r['effective_gbps']:.4g} | {r['pct_peak_hbm']:.4g}% | {r['bound']} "
                     f"| {r['roofline_ms']:.5g} | {r['operations']:.0f} |")
    lines.append(f"\nframe busy {table['full_frame_ms']:.4f} ms (median {table['frame_event_ms']:.3f} "
                 f"ms by events, idle {table['idle_share']:.1%}, {table['frame_operations']:.0f} "
                 f"device operations; stages {table['sum_stage_ms']:.4f} ms); "
                 f"{table['frame_gflops']:.5g} GFLOP, {table['frame_hbm_mb']:.5g} MB; floor "
                 f"{table['frame_roofline_ms']:.5g} ms = {table['frame_pct_of_roofline']:.4g}% of "
                 f"the busy frame; {table['frame_effective_gbps']:.4g} GB/s")
    return "\n".join(lines)
