#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mcray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the eleven CUDA kernels from mcray_tpu_torch/csrc (one nvcc per
source, all at once) and drives the port's paths at SimConfig() (512
elements x 5 paths x 10 bounces, 465 x 512 RF, 400 x 500 B-mode), each
with the launch counts set to 0 just before it and read just after:

- the sphere (2,220 triangles) on its default kernel set: listed
  intersect (K5), march (K2), postproc (K3), scan conversion (K4), plus a
  few requests (poses, seeds, a compound);
- the sphere on the brute closest hit (K1), and by BVH traversal (K11,
  ``use_bvh``: no TPU kernel, the reference's jnp while_loop);
- the 123,224-triangle ircad_hd scene on its default (listed) set, by BVH
  traversal and on the brute closest hit (the bvh frame's anchor);
- the culled (K6) and staged (K7) closest hits on both scenes;
- the ~615k-triangle ircad11_mega scene in grouped mode (K10 and its
  residual K5 pass, then K2, K3, K4) and in listed mode: one seed, so the
  two frames must agree; and by BVH traversal against its brute frame (K1);
- the isotropic 2,560-ray query on a 200,000-triangle synthetic scene that
  the grouped kernel was built for, and the same scene's coherent fan;
- the differentiable material fit on the sphere in soft + trilinear mode:
  the target frame, then 5 Adam steps of ``MaterialFitter`` on the doubled
  LIVER attenuation, through K5, K2, K3, K4 forward and the march (K8) and
  scan-conversion (K9) backward kernels;
- the parallel layer on a one-rank NCCL group (``make_mesh(device="cuda")``):
  ``ShardedRenderer``'s sphere frames 0-2 in the halo and the gathered
  imaging mode and a ``ShardedRenderer2D`` 1 x 1 frame against the
  ``Simulator``'s (RF bitwise, the gathered B-mode bitwise, the halo B-mode
  at rtol 1e-5 / atol 1e-6), K5 10, K2 1, K4 1 a frame and K3 only when
  gathered, and one sharded train step at the fit set-up against
  ``MaterialFitter`` (K8, K9 once; loss rtol 1e-4, gradient 2e-3 of its
  largest entry), then the sharded frames timed and profiled beside one
  device's (one card holds one NCCL rank: more ranks are tested on the
  CPU by gloo);
- the batched frame (``Simulator.render_frames``: every kernel launched once
  for all the frames): ``render_batch`` of 8 seeds, the pose fd step's 28
  frames at 7 poses and a ``MaterialFitter`` step of 4 frames, each against
  its frames one after another (the frames bitwise; the fit gradient within
  1e-5 of its largest entry), K5 10, K2 1, K3 1, K4 1 a batch and K8 1, K9 1
  a fit step, each timed beside its loop, profiled, its peak memory read;
  K3, K4 and K9 with the frame axis against per-frame launches and their
  plain versions; the mega listed scene's batch of 8 and its peak memory;
  the sphere's batch of 8 by BVH traversal (K11 10 launches, every frame
  bitwise ``render_frame``'s);
- the chained batch (``Simulator.make_chained_batch``: each step of 8
  frames replayed from a CUDA graph of one step), sphere 8 x 16 and
  ircad_hd 8 x 8: the last step bitwise ``render_frames`` of its keys,
  ``carry`` 0; capture ms and graph memory, beside the whole chain captured
  as one graph; the call beside the same steps run eagerly, timed in turns
  and profiled (K5, K2, K3, K4 launched from the graph, counted by the
  profiler's kernel names);
- the probe-pose paths: ``PoseFitter(method="fd")`` from the scene's pose +
  (0, 0.3, 0), 5 steps of 28 frames in one batched pass each (4 keys,
  scales 2, 4, 8), and
  ``method="ad"`` in soft + trilinear mode, 2 steps on position and angles
  (K8, K9 once a step); ``serve`` on 4 requests at three poses, one
  malformed; ``sweep``, 3 frames; ``render`` with every flag (--bvh,
  --bug-compat, --probe, --envelope, --texture, --scatter-rng, --save-rf,
  --dump-column).

Every kernel is held against its plain PyTorch version at the shapes its
path gave it (closest hits bitwise in t and slot, at every bounce; the
cluster paths' hit and t also against K1's bitwise), K1 also on 256 rays
of each ircad_hd bounce (its plain version at 123,224 triangles is too slow
for all 2,560) and at edge shapes (1, 33, 1,000 and 2,560 rays x 1, 255,
257 and 2,220 triangles, duplicated triangles, dead rays, no triangle),
K4 bitwise against its plain version from the coordinate maps, K9 bitwise
against its CSR lists summed in order on the host, K10 per ray (t and slot bitwise) at every mega grouped
bounce and on both 200,000-triangle sets, K5 also at other
packet sizes and in two passes on the mega
frame's first and a late bounce, on both 200,000-triangle sets and at
every bounce of the sphere and ircad_hd frames, K6 and K7 at packets of
100, 128, 512 and 2,048 rays at every bounce of both frames (against the
plain version at the kernel's group and at the whole packet), K3 also
on made-up images (zeros, plateaus, no peak, no convolution) and bitwise
on a 1,200- and a 2,000-row image, the CUDA path against the plain CPU path
on a small config (the frame, the loss and material gradient of one
fit step, one pose fd step's 7 point losses, the pose gradient), K11
bitwise against its plain version (t, winner, the 4-wide walk's node and
test counts) and against the binary walk and K1 (t, winner) at every bounce
of the sphere, ircad_hd and mega bvh frames and of the sphere's bvh batch of
8, each bvh frame bitwise its brute frame, a served PNG byte
for byte ``save_png`` of ``render_frame`` at its request, the keyed randomness on the card against the CPU (bits equal,
normals allclose), and every frame's image is checked. The march kernels
(K2, K8) are also held against their plain versions at full size (the
sphere frame and the fit's set-up, with bitsum and with Box–Muller
normals) and at a 64-element frame in every mode of the scatterer field
(normals x lookup x gate x a volume side of 256 and of 48, and the table
texture): K2 bitwise with bitsum normals, Box–Muller's gate flips counted
and bounded. The modes the reference runs outside its kernels (centered
PSF, Hilbert envelope, soft row binning, table texture) render a frame on
the card against the CPU path.
Frames, fit steps and kernels (beside their plain versions and,
where one PyTorch call computes the same function, beside that call) are
timed with CUDA events; each kernel's bound (the least time the card could
take: bytes over 3.35 TB/s or operations over 67 TFLOP/s of plain f32,
whichever is larger) is computed from the run's own inputs by
``mcray_tpu_torch/utils/roofline.py``, and every time is taken by
``mcray_tpu_torch/utils/benchmarking.py``. All ten
kernels are also timed replayed from a CUDA graph (the
kernels back to back, without the host's time to launch each), K1 on the
sphere brute and ircad_hd bounces, K5 on each of its ray sets, K6 and K7 on
the sphere and ircad_hd frames, K10 on the mega grouped frame, its bounces
0 and 5 and the two 200,000-triangle sets, K11 on the sphere, ircad_hd and
mega bvh bounces and the bvh batch's (its bound from the binary walk's node
and test counts), K2 and K8 in their default and
Box–Muller modes, K4 and K9 beside their library calls, and beside the time
of one launch of the library's cheapest call; the grids of K1, K3, K4, K5,
K6, K7, K9, K10 and K11 are read back and must fill half the card. The sphere
brute frame, the ircad_hd frames (listed, culled, staged) and the three
bvh frames are profiled as the sphere's and the mega scene's are. The
``[roofline]`` phase prints the stage table (``roofline.stage_table``: each
of draws, trace, march, postproc and scan conversion timed alone by the
profiler's busy ms against the floor of the work its function needs) of the
sphere frame, the sphere batch of 8, and the ircad_hd listed, mega listed
and mega bvh frames, beside the card's name and power limit; the mega listed
and mega bvh frames' trace floors must be equal.

The last lines are the kernel record ({"kernels": [...]}; each entry's
``sharded_launches`` gives its launches per sharded frame in each imaging
mode and per sharded train step, ``batch_launches`` per batched set-up,
``batch`` its time and bound per launch at the batch's shapes, and K2-K5's
``chained_replay_launches`` their launches in one chained call by scene), the card's
`nvidia-smi` name and power limit, and {"ok": true, "device": {...}}. Any
failed phase raises (exit code != 0, no result line). Without a CUDA
device it fails at once.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from mcray_tpu_torch import cli
from mcray_tpu_torch.config import SimConfig, small_test_config
from mcray_tpu_torch.models import simulator
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.models.trainer import MaterialFitter, PoseFitter, column_mask
from mcray_tpu_torch.ops import bvh, clusters, geometry, imaging, physics
from mcray_tpu_torch.ops import cuda as kernels
from mcray_tpu_torch.ops.bvh import build_bvh
from mcray_tpu_torch.ops.cuda import (_build, bvh_intersect, intersect, intersect_culled,
                                      intersect_grouped, intersect_listed, intersect_staged, march,
                                      postproc, scanconv)
from mcray_tpu_torch.utils.image_io import save_png
from mcray_tpu_torch.ops.geometry import NO_HIT_T
from mcray_tpu_torch.parallel.shard import (ShardedRenderer, ShardedRenderer2D, make_mesh,
                                            make_mesh_2d)
from mcray_tpu_torch.scene import stress
from mcray_tpu_torch.scene.compile import load_and_compile
from mcray_tpu_torch.utils import profiling, rng, roofline
from mcray_tpu_torch.utils.benchmarking import (busy_view, cuda_ms, event_ms, graph_ms,
                                               grid_sample_remap, nvidia_smi)
from mcray_tpu_torch.utils.native import get_native

REPO = os.path.dirname(os.path.abspath(__file__))
SPHERE_SCENE = os.path.join(REPO, "assets", "sphere", "sphere.scene")
IRCAD_HD_SCENE = os.path.join(REPO, "assets", "ircad11_hd", "santi-liver-hd.scene")
# the ircad_hd phantom meshes are generated here (git ignores build/)
IRCAD_HD_ASSETS = os.path.join(REPO, "build", "mcray_tpu_torch", "ircad11_hd")
MEGA_SCENE = os.path.join(REPO, "assets", "ircad11_mega", "santi-liver-mega.scene")
MEGA_ASSETS = os.path.join(REPO, "build", "mcray_tpu_torch", "ircad11_mega")
TIMED_FRAMES = {"sphere": 10, "sphere brute": 5, "sphere bvh": 5, "ircad_hd": 5,
                "ircad_hd culled": 5, "ircad_hd staged": 5, "ircad_hd bvh": 5, "mega listed": 5,
                "mega grouped": 5, "mega bvh": 5}
PROFILED_FRAMES = ("sphere", "sphere brute", "sphere bvh", "ircad_hd", "ircad_hd culled",
                   "ircad_hd staged", "ircad_hd bvh", "mega listed", "mega grouped", "mega bvh")
# the scenes whose frames also run by BVH traversal (K11), each beside its brute frame (K1)
BVH_SCENES = ("sphere", "ircad_hd", "mega")
# packet sizes K6 and K7 are also checked at, beyond the frame's 512 (any
# divisor of the padded ray count runs; 100 is no multiple of 32, 2,048 more
# rays than a block has threads), and K5 at the two its other checks leave out
CLUSTER_TILE_RS = (100, 128, 512, 2048)
LISTED_TILE_RS = (100, 2048)
MEGA_LATE_BOUNCE = 5          # the bounce timed beside bounce 0 (coherent fan) on the mega frame
ISOTROPIC_TRIS, ISOTROPIC_RAYS = 200_000, 2560
# the two mega frames (one seed, two closest-hit modes) against each other
MEGA_FRAME_RTOL, MEGA_FRAME_ATOL = 1e-3, 1e-4
# the normal draw goes through each device's erfinv
NORMAL_RTOL, NORMAL_ATOL = 1e-5, 1e-6
FIT_STEPS = 5
SHARD_FRAMES = 3          # sharded frames 0-2 held to the Simulator's, in each imaging mode
SHARD_TIMED_FRAMES = 10
# K1 on ircad_hd against its plain version: this many rays of each bounce
# (its live rays, evenly spaced), from the whole bounce's launch
IRCAD_K1_SAMPLE = 256
# K1 at the edges of its 32-ray tile and 256-triangle slice
K1_EDGE_RAYS, K1_EDGE_TRIS = (1, 33, 1000, 2560), (1, 255, 257, 2220)
TOLERANCES = {  # (rtol, atol) of kernel vs plain at the frame's shapes
    "march": (1e-4, 1e-5),
    "postproc": (1e-5, 1e-6),
    # K4 against imaging.scan_convert (the reference's map_coordinates); its
    # plain version from the maps it equals bitwise
    "scanconv": (1e-6, 1e-6),
    # soft + trilinear: 8 corners and a sigmoid per step, expf differs by an ulp
    "march soft+trilinear": (1e-4, 1e-5),
    # sums of a few w * g terms in another order (the plain scatter-add uses atomics)
    "scanconv_bwd": (1e-5, 1e-6),
}
# K8 sums up to ~466 steps per field in another order than the plain
# version's row reduction: per field, max |kernel - plain| <= this x max |plain|
MARCH_BWD_TOL = 1e-4
# one fit step on the card against the CPU plain path (small config, same
# draws): the loss, and the material gradient relative to its largest entry
# (the trace's backward amplifies the ulp differences of exp/log/pow/sin
# between the two devices; the reference's own kernel-vs-plain gradient
# test allows 2e-3 in trilinear mode)
FIT_LOSS_RTOL, FIT_GRAD_TOL = 1e-4, 5e-3
# pose registration from the scene's pose + POSE_OFFSET: fd steps at full
# width, ad steps in soft + trilinear mode; the fd step's 7 point losses and
# the ad pose gradient at a small config, card against CPU (the CPU tests'
# tolerances: tests/test_torch_pose.py, tests/test_torch_pose_ad.py)
POSE_OFFSET = (0.0, 0.3, 0.0)
POSE_FD_STEPS, POSE_AD_STEPS = 5, 2
POSE_LOSS_RTOL, POSE_GRAD_TOL = 1e-4, 5e-3
# the batched frame: bench.py's batch of 8 seeds, a fit step of 4 frames;
# the batched fit step's gradient against its loop, relative to its largest
# entry (the frames' contributions summed in another order; the card's
# gather backward adds with atomics)
BATCH_SEEDS = tuple(range(8))
BATCH_FIT_FRAMES, BATCH_TIMED = 4, 10
FIT_BATCH_GRAD_TOL = 1e-5
SWEEP_FRAMES = 3
# the chained batch: scene -> (batch, n_chain), bench.py's set-ups; the seed0 of its first call
CHAINED = {"sphere": (8, 16), "ircad_hd": (8, 8)}
CHAINED_SEED = 10
# the stage tables (roofline.stage_table): label -> (the frame's Simulator, its seeds, the
# [bvh] ray set whose reference walks its trace floor reads where they are of its rays)
ROOFLINE_FRAMES = {"sphere": ("sphere", (0,), "sphere"),
                   "sphere batch of 8": ("sphere", BATCH_SEEDS, "batch"),
                   "ircad_hd listed": ("ircad_hd", (0,), "ircad_hd"),
                   "mega listed": ("mega listed", (0,), "mega"),
                   "mega bvh": ("mega bvh", (0,), "mega")}

SOURCES = {  # kernel: (source, TPU kernel it replaces)
    "intersect": ("mcray_tpu_torch/csrc/intersect.cu", "mcray_tpu/ops/pallas/intersect.py:41"),
    "intersect_listed": ("mcray_tpu_torch/csrc/intersect_listed.cu",
                         "mcray_tpu/ops/pallas/intersect.py:859"),
    "intersect_culled": ("mcray_tpu_torch/csrc/intersect_culled.cu",
                         "mcray_tpu/ops/pallas/intersect.py:1461"),
    "intersect_staged": ("mcray_tpu_torch/csrc/intersect_staged.cu",
                         "mcray_tpu/ops/pallas/intersect.py:460"),
    "intersect_grouped": ("mcray_tpu_torch/csrc/intersect_grouped.cu",
                          "mcray_tpu/ops/pallas/intersect.py:1151"),
    "march": ("mcray_tpu_torch/csrc/march.cu", "mcray_tpu/ops/pallas/march.py:233"),
    "postproc": ("mcray_tpu_torch/csrc/postproc.cu", "mcray_tpu/ops/pallas/postproc.py:26"),
    "scanconv": ("mcray_tpu_torch/csrc/scanconv.cu", "mcray_tpu/ops/pallas/scanconv.py:447"),
    "march_bwd": ("mcray_tpu_torch/csrc/march_bwd.cu", "mcray_tpu/ops/pallas/march.py:334"),
    "scanconv_bwd": ("mcray_tpu_torch/csrc/scanconv_bwd.cu",
                     "mcray_tpu/ops/pallas/scanconv.py:482"),
    # no TPU kernel: the reference's BVH traversal is a jnp while_loop
    "bvh_intersect": ("mcray_tpu_torch/csrc/bvh_intersect.cu", "mcray_tpu/ops/bvh.py:121"),
}
# the TPU kernels K4 and K9 replace beside the one in SOURCES (one gather
# each for the banded and the full remap, and for their backward passes)
ALSO_REPLACES = {"scanconv": "mcray_tpu/ops/pallas/scanconv.py:162",
                 "scanconv_bwd": "mcray_tpu/ops/pallas/scanconv.py:199"}
CLUSTER_KERNEL = {"listed": "intersect_listed", "culled": "intersect_culled",
                  "staged": "intersect_staged", "grouped": "intersect_grouped"}


def paired_ms(kernel_fn, plain_fn, per_call: int, k_reps: int = 10, p_reps: int = 3):
    """(kernel, plain) ms per launch, timed kernel, plain, plain, kernel."""
    k1 = cuda_ms(kernel_fn, k_reps)
    p1 = cuda_ms(plain_fn, p_reps)
    p2 = cuda_ms(plain_fn, p_reps)
    k2 = cuda_ms(kernel_fn, k_reps)
    return (k1 + k2) / 2 / per_call, (p1 + p2) / 2 / per_call


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    rtol, atol = TOLERANCES[name]
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: kernel != plain (max abs err {err}, rtol {rtol}, atol {atol})")
    print(f"  {name}: max abs err {err:.3e} (rtol {rtol}, atol {atol}) ok")
    return err


def check_bmode(name: str, sim, bmode: torch.Tensor) -> None:
    """Finite, non-negative B-mode of the right shape: zero outside the fan,
    texture inside."""
    cfg = sim.cfg
    table = sim.scan_maps.table[:, :, : cfg.bmode_cols]
    outside = ((table[:, 1] == 0) & (table[:, 2] == 0)) | ((table[:, 4] == 0) & (table[:, 5] == 0))
    if tuple(bmode.shape) != (cfg.bmode_rows, cfg.bmode_cols):
        raise AssertionError(f"{name}: bmode shape {tuple(bmode.shape)}")
    if not bool(torch.isfinite(bmode).all()) or float(bmode.min()) < 0.0:
        raise AssertionError(f"{name}: bmode is not finite and non-negative")
    if float(bmode[outside].abs().max()) != 0.0:
        raise AssertionError(f"{name}: bmode is not zero outside the fan")
    fan_std = float(bmode[~outside].std())
    if not fan_std > 0.0:
        raise AssertionError(f"{name}: bmode has no texture inside the fan")
    print(f"  bmode {tuple(bmode.shape)}: min {float(bmode.min()):.4g} max {float(bmode.max()):.4g} "
          f"fan std {fan_std:.4g}; {int(outside.sum())} pixels outside the fan are 0")


def drive(name: str, sim, expected: dict[str, int], seed: int = 0):
    """One frame through ``sim`` with the launch counts set to 0 just
    before and read just after; every count must be as ``expected`` (0 for
    the kernels not named)."""
    print(f"[path] {name}: {sim.pack.n_triangles} triangles, intersect {sim.intersect}, tile_r "
          f"{sim.intersect_tile_r}")
    kernels.reset_launch_counts()
    out = sim.render_frame(seed=seed)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"  launches: {counts}")
    want = {k: expected.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{name}: launch counts {counts} != {want}")
    check_bmode(name, sim, out["bmode"])
    return out, counts


def listed_args(o, s, packed, tile_r: int) -> tuple:
    """K5's arguments for one ray set: padded rays, the packets' lists, the
    running best's start (inert lanes at t = 0)."""
    op, sp, padded = clusters.pad_rays(o, s, tile_r)
    live = torch.abs(sp).sum(dim=1) > 0.0
    return (padded, *clusters.packet_cluster_lists(op, sp, packed, tile_r),
            torch.where(live, NO_HIT_T, 0.0), torch.zeros_like(live, dtype=torch.int32), packed)


def grouped_args(o, s, packed, tile_r: int) -> tuple[tuple, dict]:
    """K10's arguments for one ray set (padded rays, each cluster's ray
    table) and what the prepass found: live rays, (ray, cluster) incidences,
    how many the tables hold, and the share of clusters that dropped a ray."""
    op, sp, padded = clusters.pad_rays(o, s, tile_r, 1e9)
    hit_m, live = clusters.ray_cluster_hits(op, sp, packed)
    ray_ids, counts, overflow = clusters.cluster_ray_tables(
        hit_m, intersect_grouped.GROUP_G, intersect_grouped.CHUNK_G)
    n_live = int(live.sum())
    stats = {"live": n_live, "incidences": int(hit_m.sum()), "in_table": int(counts.sum()),
             "clusters_with_rays": int((counts > 0).sum()),
             "overflow_share": float(overflow.float().mean()),
             "per_ray": int(hit_m.sum()) / max(n_live, 1)}
    return (padded, ray_ids, counts, packed), stats


def cluster_call(mode: str, o, s, packed, tile_r: int):
    """(kernel, plain, arguments) of ``mode``'s cluster kernel for one ray set."""
    if mode == "grouped":
        return (intersect_grouped.grouped_winners, intersect_grouped.grouped_winners_plain,
                grouped_args(o, s, packed, tile_r)[0])
    if mode == "listed":
        return (intersect_listed.listed_best, intersect_listed.listed_best_plain,
                listed_args(o, s, packed, tile_r))
    mod = intersect_culled if mode == "culled" else intersect_staged
    padded = clusters.pad_rays(o, s, tile_r)[2]
    return getattr(mod, f"{mode}_best"), getattr(mod, f"{mode}_best_plain"), (padded, packed, tile_r)


def check_listed_shapes(label: str, ray_sets, packed, tri_soa, tile_rs=(128, 512)) -> None:
    """K5 on ray sets [(origins, segments), ...] at other shapes than its
    frame launches it with: packets of each of ``tile_rs`` rays, each
    against the plain version at the kernel's group size and at the whole
    packet (t and slot bitwise), and the closest hit in one pass and in two
    (the second launch seeded with the first's running best) against K1
    (hit and t bitwise)."""
    vs_plain = vs_brute = n_hit = 0
    for o, s in ray_sets:
        bt, _ = intersect.intersect_best(torch.cat([o, s], dim=1).T.contiguous(), tri_soa)
        n_hit += int((bt < 1.5).sum())
        for tile_r in tile_rs:
            args = listed_args(o, s, packed, tile_r)
            t_k, i_k = intersect_listed.listed_best(*args)
            for group in (intersect_listed.GROUP, None):
                t_p, i_p = intersect_listed.listed_best_plain(*args, group=group)
                vs_plain += int((t_k != t_p).sum() + (i_k != i_p).sum())
            for passes in (1, 2):
                got = intersect_listed.intersect_closest_listed(o, s, packed, tile_r=tile_r,
                                                                passes=passes)
                vs_brute += int((got["hit"] != (bt < 1.5)).sum() + (got["t"] != bt).sum())
    print(f"  intersect_listed ({label}; tile_r {', '.join(map(str, tile_rs))}; plain at group "
          f"{intersect_listed.GROUP} and at the whole packet; passes 1 and 2): {vs_plain} "
          f"differing (t, slot) vs plain, {vs_brute} differing (hit, t) vs K1 brute; "
          f"{n_hit} of {sum(o.shape[0] for o, _ in ray_sets)} rays hit")
    if vs_plain or vs_brute:
        raise AssertionError(f"{label}: intersect_listed disagrees")


def bounce_sets(rays: torch.Tensor) -> list:
    """A frame's (depth, 6, n) bounce rays as [(origins, segments), ...]."""
    return [(rays[d][0:3].T.contiguous(), rays[d][3:6].T.contiguous())
            for d in range(rays.shape[0])]


def check_cluster_shapes(name: str, sim, rays: torch.Tensor, tri_soa) -> None:
    """K6 or K7 (the path's kernel) at packets of CLUSTER_TILE_RS rays, at
    every bounce of the frame: t and slot bitwise against the plain version
    at the kernel's group and at the whole packet, and the whole closest
    hit's hit and t against K1's (bitwise)."""
    packed, mode = sim.culled_tris
    mod = intersect_culled if mode == "culled" else intersect_staged
    kernel, plain = getattr(mod, f"{mode}_best"), getattr(mod, f"{mode}_best_plain")
    vs_plain = vs_brute = 0
    for d, (o, s) in enumerate(bounce_sets(rays)):
        bt, _ = intersect.intersect_best(rays[d].contiguous(), tri_soa)
        for tile_r in CLUSTER_TILE_RS:
            padded = clusters.pad_rays(o, s, tile_r)[2]
            t_k, i_k = kernel(padded, packed, tile_r)
            for group in (mod.GROUP, None):
                t_p, i_p = plain(padded, packed, tile_r, group=group)
                vs_plain += int((t_k != t_p).sum() + (i_k != i_p).sum())
            got = simulator.cluster_intersect(mode, tile_r)(o, s, packed)
            vs_brute += int((got["hit"] != (bt < 1.5)).sum() + (got["t"] != bt).sum())
    print(f"  {CLUSTER_KERNEL[mode]} ({name}; tile_r {', '.join(map(str, CLUSTER_TILE_RS))}; plain "
          f"at group {mod.GROUP} and at the whole packet; {rays.shape[0]} bounces): {vs_plain} "
          f"differing (t, slot) vs plain, {vs_brute} differing (hit, t) vs K1 brute")
    if vs_plain or vs_brute:
        raise AssertionError(f"{name}: {CLUSTER_KERNEL[mode]} disagrees at another packet size")


def k1_edge_case(n: int, t: int) -> tuple:
    """(rays (6, n), tri_soa (9, t)) on the card: random triangles in a
    10-unit box whose first t // 2 come again at the top indices (equal t:
    the lower index must win), half the rays aimed through triangle
    centroids, and a ragged stretch of 45 parked dead rays from n // 3 (when
    n > 32)."""
    g = torch.Generator().manual_seed(n * 10_007 + t)
    base = (torch.rand((t - t // 2, 1, 3), generator=g) * 10 - 5
            + torch.randn((t - t // 2, 3, 3), generator=g) * 0.8)
    tris = torch.cat([base, base[: t // 2]])
    o = torch.rand((n, 3), generator=g) * 12 - 6
    s = torch.randn((n, 3), generator=g) * 8
    if t:
        aim = torch.randint(0, t, (n // 2,), generator=g)
        s[: n // 2] = (tris[aim].mean(dim=1) - o[: n // 2]) * 1.25
    if n > 32:
        o[n // 3 : n // 3 + 45], s[n // 3 : n // 3 + 45] = 1e9, 0.0
    return torch.cat([o, s], dim=1).T.contiguous().cuda(), geometry.triangle_soa(tris.cuda())


def check_k1_edges() -> dict:
    """K1 at K1_EDGE_RAYS x K1_EDGE_TRIS, on 600 parked dead rays and on
    2,560 rays against no triangle: t and index bitwise against its plain
    version; the dead rays and the empty scene miss, (2.0, 0)."""
    cases = [(f"{n} x {t}", *k1_edge_case(n, t)) for n in K1_EDGE_RAYS for t in K1_EDGE_TRIS]
    dead = torch.cat([torch.full((3, 600), 1e9), torch.zeros((3, 600))]).cuda()
    cases += [("600 dead x 2220", dead, k1_edge_case(1, 2220)[1]),
              ("2560 x 0", k1_edge_case(2560, 1)[0], torch.zeros((9, 0), device="cuda"))]
    differing, hits, blocks = 0, {}, {}
    for label, rays, soa in cases:
        t_k, i_k = intersect.intersect_best(rays, soa)
        blocks[label] = intersect.last_blocks
        t_p, i_p = intersect.intersect_best_plain(rays, soa)
        differing += int((t_k.view(torch.int32) != t_p.view(torch.int32)).sum() + (i_k != i_p).sum())
        hits[label] = int((t_k < 1.5).sum())
    print(f"  intersect at {len(cases)} edge shapes (rays x triangles: "
          f"{', '.join(map(str, K1_EDGE_RAYS))} x "
          f"{', '.join(map(str, K1_EDGE_TRIS))}; 600 dead rays; no triangle): {differing} differing "
          f"(t, index) vs plain; hits {hits}; blocks {blocks}")
    if differing or hits["600 dead x 2220"] or hits["2560 x 0"] or hits["2560 x 2220"] < 640:
        raise AssertionError("intersect disagrees with its plain version at an edge shape")
    return {"cases": len(cases), "differing": differing, "blocks": blocks}


def check_k1_sample(bounce_rays, tri_soa) -> dict:
    """K1 launched on each whole bounce, held at IRCAD_K1_SAMPLE of its rays
    (the live ones evenly spaced, then dead ones where fewer are live)
    against its plain version on those rays, t and index bitwise."""
    differing = checked = n_hit = 0
    for rays in bounce_rays:
        t_k, i_k = intersect.intersect_best(rays, tri_soa)
        live = rays[3:6].abs().sum(dim=0) > 0
        on, off = torch.nonzero(live).squeeze(1), torch.nonzero(~live).squeeze(1)
        k = min(IRCAD_K1_SAMPLE, on.numel())
        pick = torch.cat([on[torch.linspace(0, max(on.numel() - 1, 0), k, device=on.device).long()],
                          off[: IRCAD_K1_SAMPLE - k]])
        t_p, i_p = intersect.intersect_best_plain(rays[:, pick].contiguous(), tri_soa)
        differing += int((t_k[pick].view(torch.int32) != t_p.view(torch.int32)).sum()
                         + (i_k[pick] != i_p).sum())
        checked += pick.numel()
        n_hit += int((t_p < 1.5).sum())
    print(f"  intersect (ircad_hd, {tri_soa.shape[1]} triangles; each bounce launched whole, "
          f"{IRCAD_K1_SAMPLE} rays of each held against plain): {differing} differing (t, index) "
          f"over {checked} rays, {n_hit} hit")
    if differing or not n_hit:
        raise AssertionError("intersect (ircad_hd) != plain")
    return {"rays_checked": checked, "differing": differing, "hits": n_hit}


def made_up_images() -> list:
    """(name, image) for K3 beside the frame's RF: all zeros; noise with a
    falling column (no peak), a column of 5-row plateaus, a flat column and a
    plateau across every column; an image narrower than the lateral window
    (no convolution); two rows (no envelope); a ragged last strip."""
    g = torch.Generator().manual_seed(9)
    shaped = torch.randn((465, 64), generator=g)
    shaped[:, 3] = torch.linspace(1.0, -1.0, 465)
    shaped[:, 4] = (torch.arange(465).div(5, rounding_mode="floor") % 3).float()
    shaped[:, 5] = 0.25
    shaped[100:140, :] = shaped[100:101, :]
    return [("zeros", torch.zeros((465, 512))), ("plateaus and no peak", shaped),
            ("narrower than the lateral window", torch.randn((465, 16), generator=g)),
            ("two rows", torch.randn((2, 40), generator=g)),
            ("ragged strip", torch.randn((61, 37), generator=g))]


def check_cluster_bounces(name: str, sim, rays: torch.Tensor, tri_soa) -> list:
    """The path's cluster kernel against its plain version (t and slot
    bitwise; for K10 each padded ray's winner over its cluster tables) and
    the whole cluster closest hit's hit and t against K1's (bitwise), at
    every bounce's rays of the frame; returns the per-bounce (kernel, plain,
    arguments)."""
    packed, mode = sim.culled_tris
    tile_r = sim.intersect_tile_r
    closest = simulator.cluster_intersect(mode, tile_r)
    calls = []
    differing = vs_brute = 0
    for d in range(rays.shape[0]):
        o, s = rays[d][0:3].T.contiguous(), rays[d][3:6].T.contiguous()
        kernel, plain, args = cluster_call(mode, o, s, packed, tile_r)
        t_k, i_k = kernel(*args)
        t_p, i_p = plain(*args)
        differing += int((t_k.view(torch.int32) != t_p.view(torch.int32)).sum()
                         + (i_k != i_p).sum())
        got = closest(o, s, packed)
        bt, _ = intersect.intersect_best(rays[d].contiguous(), tri_soa)
        vs_brute += int((got["hit"] != (bt < 1.5)).sum() + (got["t"] != bt).sum())
        calls.append((kernel, plain, args))
    print(f"  {CLUSTER_KERNEL[mode]} ({name}): {differing} differing (t, slot) vs plain, "
          f"{vs_brute} differing (hit, t) vs K1 brute, over {rays.shape[0]} bounces")
    if differing or vs_brute:
        raise AssertionError(f"{name}: {CLUSTER_KERNEL[mode]} disagrees")
    return calls


def time_frames(name: str, sim, n: int) -> float:
    seeds = iter(range(100, 100 + n))
    frame_ms = event_ms(lambda: sim.render_frame(seed=next(seeds)), n)
    med = statistics.median(frame_ms)
    print(f"  {name} frame: median {med:.3f} ms over {n} frames (min {min(frame_ms):.3f}, "
          f"max {max(frame_ms):.3f}); {sim.rays_per_frame / med * 1e3:,.0f} rays/s "
          f"({sim.rays_per_frame} rays/frame)")
    return med


def cluster_bound(sim, calls) -> roofline.Bound:
    """``roofline.cluster_bound`` of a cluster kernel's launches on ``sim``'s
    clusters: each launch's padded rays, its final t and K5's lists."""
    packed, mode = sim.culled_tris
    return roofline.cluster_bound(packed, [(a[0], k(*a)[0], a[1:4] if mode == "listed" else ())
                                           for k, _, a in calls])


def check_march_bwd(got: torch.Tensor, want: torch.Tensor) -> float:
    """K8 against its plain version, field by field (all 16)."""
    worst = 0.0
    for f in range(march.N_FIELDS):
        err = float((got[:, f] - want[:, f]).abs().max())
        scale = float(want[:, f].abs().max())
        if err > MARCH_BWD_TOL * scale:
            raise AssertionError(f"march_bwd field {f}: max abs err {err} vs max |plain| {scale}")
        worst = max(worst, err / scale if scale else 0.0)
    zero = [march.F_T0, march.F_STEPS, march.F_B_ROW, march.F_VALID]
    if float(got[:, zero].abs().max()) != 0.0 or not float(got.abs().max()) > 0.0:
        raise AssertionError("march_bwd: a piecewise-constant field has a gradient, or all are zero")
    print(f"  march_bwd: 16 fields, worst max abs err / max |plain| {worst:.3e} "
          f"(limit {MARCH_BWD_TOL}) ok")
    return float((got - want).abs().max())


def check_scanconv_bwd(g_bm, maps, cfg) -> float:
    """K9 bitwise against its CSR lists summed in list order on the host
    (from +0.0, each product rounded: the kernel's order), and within
    TOLERANCES of the scatter-add plain version; returns the max abs error
    against the latter."""
    got = scanconv.scan_convert_backward(g_bm, maps)
    row_ptr, pixel, weight = (a.cpu().numpy() for a in (maps.row_ptr, maps.pixel, maps.weight))
    in_order = np.zeros(cfg.rf_rows * cfg.rf_cols, np.float32)
    np.add.at(in_order, np.repeat(np.arange(in_order.size), np.diff(row_ptr)),
              weight * g_bm.cpu().numpy().reshape(-1)[pixel])
    differing = int((got.cpu().view(torch.int32).reshape(-1)
                     != torch.from_numpy(in_order).view(torch.int32)).sum())
    print(f"  scanconv_bwd: {differing} differing cells vs the CSR lists summed in order "
          f"({pixel.size} taps)")
    if differing:
        raise AssertionError("scanconv_bwd kernel != its CSR lists summed in order")
    return check_close("scanconv_bwd", got,
                       scanconv.scan_convert_bwd_plain(g_bm, maps.table, cfg.rf_rows, cfg.rf_cols))


def device_view(label: str, fn, unit_ms: float, n: int = 3, top: int = 8,
                expect: dict[str, int] | None = None) -> dict:
    """The device's view of ``n`` calls of ``fn`` by ``torch.profiler``: busy
    time (the union of the device events' intervals) per call, its share of
    the unprofiled median ``unit_ms``, device operations per call and the
    largest kernels; ``expect`` as ``busy_view`` takes it (the launches a call
    makes by kernel name, for a window that lost none). Returns
    ``benchmarking.busy_view``'s busy ms, operations and ms by kernel name,
    per call."""
    view = busy_view(fn, n, expect=expect)
    busy_ms = view["busy_ms"]
    print(f"  {label} profile over {n} calls: device busy {busy_ms:.3f} ms per call "
          f"({busy_ms / unit_ms:.1%} of the unprofiled median {unit_ms:.3f} ms, idle "
          f"{1 - busy_ms / unit_ms:.1%}); {view['operations']:.0f} device operations per call")
    for name, ms in sorted(view["by_name"].items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {ms:8.3f} ms per call  {name[:90]}")
    return view


def fit_phase(pack, smi: str) -> dict:
    """The differentiable material fit at full width on the card: the target
    frame, FIT_STEPS Adam steps on the doubled LIVER attenuation with fixed
    randomness, the launch counts of that run, then step timings."""
    cfg = SimConfig(soft_scattering=True, trilinear_texture=True)
    sim = Simulator(pack, cfg, device="cuda", seed=0)
    row, col = 3, physics.ATTENUATION  # LIVER, the box medium
    draws = sim.draws(0)
    with torch.no_grad():
        frame = sim.render_frame(draws=draws)
    check_bmode("fit target", sim, frame["bmode"])
    perturbed = pack.materials.copy()
    perturbed[row, col] *= 2.0

    def fitter():
        return MaterialFitter.from_simulator(sim, perturbed, frame["bmode"], trainable=(col,),
                                             trainable_rows=[row], fixed_frame=draws)

    fit = fitter()
    print(f"[fit] sphere, soft + trilinear, {FIT_STEPS} steps on materials[{row}, {col}] "
          f"(true {pack.materials[row, col]:.4g}, start {perturbed[row, col]:.4g})")
    kernels.reset_launch_counts()
    losses, grads = [], []
    for _ in range(FIT_STEPS):
        losses.append(fit.step(draws))
        grads.append(fit.last_grad.clone())
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    per_step = {"intersect_listed": cfg.max_depth, "march": 1, "postproc": 1, "scanconv": 1,
                "march_bwd": 1, "scanconv_bwd": 1}
    want = {k: per_step.get(k, 0) * len(losses) for k in counts}
    print(f"  launches over {len(losses)} steps: {counts}")
    if counts != want:
        raise AssertionError(f"fit launch counts {counts} != {want}")
    fitted = float(fit.state.materials[row, col])
    print(f"  losses {[f'{v:.6g}' for v in losses]}; fitted {fitted:.5g}; "
          f"gradient on the trained entry {[f'{float(g[row, col]):.4g}' for g in grads]}")
    off = torch.ones_like(grads[0], dtype=torch.bool)
    off[row, col] = False
    for g in grads:
        if not bool(torch.isfinite(g).all()) or float(g[row, col]) == 0.0 or bool((g[off] != 0).any()):
            raise AssertionError("fit gradient: not finite, zero on the trained entry, or "
                                 "non-zero on a masked one")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"fit losses {losses}: not finite, or the last is not below the first")
    untouched = fit.state.materials.cpu().numpy()
    untouched[row, col] = pack.materials[row, col]
    if not (untouched == pack.materials).all():
        raise AssertionError("the fit moved an untrained material entry")

    # timing: whole steps, then forward and backward apart, on a fresh fitter
    fit = fitter()
    fit.step(draws)
    step_ms, fwd_ms, bwd_ms = event_ms(lambda: fit.step(draws), FIT_STEPS), [], []
    mats = fit.state.materials.requires_grad_(True)
    for _ in range(FIT_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss = fit.loss(mats, draws)
        ev[1].record()
        loss.backward()
        ev[2].record()
        ev[2].synchronize()
        fwd_ms.append(ev[0].elapsed_time(ev[1]))
        bwd_ms.append(ev[1].elapsed_time(ev[2]))
    g_rf = torch.randn(frame["rf_raw"].shape, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(3))
    pp_bwd = cuda_ms(lambda: postproc.postproc_bwd_plain(frame["rf_raw"], g_rf, cfg), 5)
    print(f"  [{smi}] fit step: median {statistics.median(step_ms):.3f} ms "
          f"(min {min(step_ms):.3f}, max {max(step_ms):.3f}) over {FIT_STEPS} steps; forward "
          f"{statistics.median(fwd_ms):.3f} ms, backward {statistics.median(bwd_ms):.3f} ms; "
          f"postproc backward (plain PyTorch autograd, no kernel) {pp_bwd:.3f} ms")
    device_view("fit step", lambda: fit.step(draws), statistics.median(step_ms))
    return {"sim": sim, "frame": frame, "counts": counts, "steps": len(losses), "cfg": cfg}


def fit_cuda_vs_cpu(pack) -> None:
    """One fit step at a small soft + trilinear config with the same draws:
    loss and material gradient on the card against the CPU plain path."""
    small = small_test_config(soft_scattering=True, trilinear_texture=True)
    cpu_sim = Simulator(pack, small, device="cpu", seed=5)
    gpu_sim = Simulator(pack, small, device="cuda", seed=5)
    draws = cpu_sim.draws(5)
    perturbed = pack.materials.copy()
    perturbed[3, physics.ATTENUATION] *= 2.0
    result = {}
    for name, sim in (("cpu", cpu_sim), ("cuda", gpu_sim)):
        d = {k: v.to(sim.device) for k, v in draws.items()}
        with torch.no_grad():
            target = sim.render_frame(draws=d)["bmode"]
        mats = torch.tensor(perturbed, device=sim.device, requires_grad=True)
        loss = torch.mean((sim.render_frame(materials=mats, draws=d)["bmode"] - target) ** 2)
        loss.backward()
        result[name] = (float(loss.detach()), mats.grad.cpu())
    (l_c, g_c), (l_g, g_g) = result["cpu"], result["cuda"]
    scale = float(g_c.abs().max())
    err = float((g_g - g_c).abs().max()) / scale
    print(f"[cuda vs cpu] fit step, small soft + trilinear config: loss {l_g:.8g} vs {l_c:.8g}; "
          f"material gradient max abs err / max |cpu| {err:.3e} (limits {FIT_LOSS_RTOL}, "
          f"{FIT_GRAD_TOL})")
    if not (abs(l_g - l_c) <= FIT_LOSS_RTOL * abs(l_c) and err <= FIT_GRAD_TOL
            and bool(torch.isfinite(g_g).all()) and scale > 0):
        raise AssertionError("the fit step on the card disagrees with the CPU plain path")


def compare_mega_frames(grouped: dict, listed: dict) -> None:
    """One seed through two closest-hit modes: the same closest hit at every
    bounce, so the same rays and segments bitwise, and the same images."""
    for key in ("rays", "valid", "media_id", "to", "reflected"):
        if not torch.equal(grouped["segments"][key], listed["segments"][key]):
            raise AssertionError(f"mega grouped vs listed: segments[{key!r}] differ")
    diffs = {}
    for key in ("rf_raw", "bmode"):
        diffs[key] = float((grouped[key] - listed[key]).abs().max())
        if not torch.allclose(grouped[key], listed[key], rtol=MEGA_FRAME_RTOL,
                              atol=MEGA_FRAME_ATOL):
            raise AssertionError(f"mega grouped vs listed: {key} max abs diff {diffs[key]}")
    print(f"  mega grouped vs mega listed: rays and segments equal at all "
          f"{grouped['segments']['valid'].shape[0]} bounces; max abs diff rf_raw "
          f"{diffs['rf_raw']:.3e}, bmode {diffs['bmode']:.3e} (rtol {MEGA_FRAME_RTOL}, atol "
          f"{MEGA_FRAME_ATOL})")


def time_grouped_query(label: str, o, s, packed, tile_r: int) -> dict:
    """One ray set: K10 beside its plain version, its bound and K5 (the
    listed path's kernel) on the same rays, and the whole grouped query
    (prepass, K10, winner, residual K5, tail) beside the whole listed query."""
    g_args, stats = grouped_args(o, s, packed, tile_r)
    l_args = listed_args(o, s, packed, tile_r)
    k10, k10_plain = paired_ms(lambda: intersect_grouped.grouped_winners(*g_args),
                               lambda: intersect_grouped.grouped_winners_plain(*g_args), 1,
                               k_reps=20, p_reps=2)
    k10_device = graph_ms(lambda: intersect_grouped.grouped_winners(*g_args), 1)
    stats.update(blocks=intersect_grouped.last_blocks)
    k5 = cuda_ms(lambda: intersect_listed.listed_best(*l_args), 10)
    whole_g = cuda_ms(lambda: intersect_grouped.intersect_closest_grouped(
        o, s, packed, residual_tile_r=tile_r), 5)
    whole_l = cuda_ms(lambda: intersect_listed.intersect_closest_listed(
        o, s, packed, tile_r=tile_r), 5)
    b_ms, b_by = roofline.grouped_bound([g_args])
    lists = int(l_args[1].sum())
    print(f"  {label}: {stats['live']} live rays, {stats['per_ray']:.2f} clusters per ray "
          f"({stats['incidences']} incidences, {stats['in_table']} in the tables of "
          f"{stats['clusters_with_rays']} clusters), {stats['overflow_share']:.1%} of clusters "
          f"overflowed; listed packets list {lists} clusters in all")
    print(f"    K10 {k10:.4f} ms, device {k10_device:.5f} (plain {k10_plain:.4f}, bound {b_ms:.5f} "
          f"by {b_by}; {stats['blocks']} blocks), K5 on the "
          f"same rays {k5:.4f} ms; whole grouped query {whole_g:.3f} ms, whole listed query "
          f"{whole_l:.3f} ms ({'grouped' if whole_g < whole_l else 'listed'} faster)")
    return {"k10_ms": k10, "k10_device_ms": k10_device, "k10_plain_ms": k10_plain,
            "bound_ms": b_ms, "bound_by": b_by, "k5_ms": k5, "grouped_query_ms": whole_g,
            "listed_query_ms": whole_l, **stats}


def isotropic_phase(smi: str) -> tuple[dict, dict]:
    """The query the grouped kernel was built for: 2,560 isotropic rays (and
    a 2,560-ray coherent fan) against a 200,000-triangle synthetic scene.
    Grouped = listed = K1 bitwise in hit and t, K5 at its other shapes; then
    the timings. Returns them and K5's arguments for each ray set."""
    t0 = time.perf_counter()
    tris, mids = stress.build_scene_arrays(ISOTROPIC_TRIS)
    fan_o, fan_s, iso_o, iso_s = (torch.from_numpy(a).cuda()
                                  for a in stress.make_rays(ISOTROPIC_RAYS))
    packed = clusters.pack_tris_culled(tris, mids, build_bvh(tris).tri_order,
                                       sort_origin=fan_o[0].cpu().numpy(), tile_t=128,
                                       device="cuda")
    tri_soa = geometry.triangle_soa(torch.from_numpy(tris).cuda())
    tile_r = 512
    print(f"[isotropic] {smi}: {tris.shape[0]} triangles in {packed.n_clusters} clusters "
          f"(scene, BVH and packing {time.perf_counter() - t0:.1f} s), {ISOTROPIC_RAYS} rays, "
          f"{tile_r}-ray packets")
    result, ray_sets = {}, {}
    for name, (o, s) in {"fan": (fan_o, fan_s), "isotropic": (iso_o, iso_s)}.items():
        kernels.reset_launch_counts()
        got = intersect_grouped.intersect_closest_grouped(o, s, packed, residual_tile_r=tile_r)
        counts = kernels.launch_counts()
        listed = intersect_listed.intersect_closest_listed(o, s, packed, tile_r=tile_r)
        bt, _ = intersect.intersect_best(torch.cat([o, s], dim=1).T.contiguous(), tri_soa)
        torch.cuda.synchronize()
        differing = int((got["hit"] != (bt < 1.5)).sum() + (got["t"] != bt).sum()
                        + (listed["hit"] != (bt < 1.5)).sum() + (listed["t"] != bt).sum())
        print(f"  {name}: {int(got['hit'].sum())} of {o.shape[0]} rays hit; {differing} differing "
              f"(hit, t) among grouped, listed and K1; one grouped query launches K10 x "
              f"{counts['intersect_grouped']}, K5 x {counts['intersect_listed']}")
        if differing or counts["intersect_grouped"] != 1 or counts["intersect_listed"] != 1 \
                or not int(got["hit"].sum()) > 100:
            raise AssertionError(f"isotropic phase, {name} rays: grouped, listed and K1 disagree")
        g_args = grouped_args(o, s, packed, tile_r)[0]
        t_k, i_k = intersect_grouped.grouped_winners(*g_args)
        t_p, i_p = intersect_grouped.grouped_winners_plain(*g_args)
        k10_differing = int((t_k.view(torch.int32) != t_p.view(torch.int32)).sum()
                            + (i_k != i_p).sum())
        print(f"  {name}: K10 per ray against its plain version: {k10_differing} differing "
              f"(t, slot) over {t_k.numel()} padded rays")
        if k10_differing:
            raise AssertionError(f"isotropic phase, {name} rays: intersect_grouped != plain")
        check_listed_shapes(f"stress 200k {name}", [(o, s)], packed, tri_soa)
        result[name] = time_grouped_query(f"{name} rays", o, s, packed, tile_r)
        ray_sets[name] = listed_args(o, s, packed, tile_r)
        result[name]["k1_ms"] = cuda_ms(lambda: intersect.intersect_best(
            torch.cat([o, s], dim=1).T.contiguous(), tri_soa), 3)
        print(f"    K1 brute on the same rays {result[name]['k1_ms']:.3f} ms")
    return result, ray_sets


def rng_phase(sim, smi: str) -> dict:
    """The keyed randomness on the card against the CPU (keys, bits,
    uniforms and integers equal; the normal through each device's erfinv),
    one seed giving one frame, and what a frame's draws cost."""
    ids = torch.arange(sim.cfg.transducer_elements * sim.cfg.samples_per_element)
    key = rng.prng_key(12)
    on = {dev: rng.fold_in(rng.fold_in(key.to(dev), 0), ids.to(dev)) for dev in ("cpu", "cuda")}
    equal = torch.equal(on["cuda"].cpu(), on["cpu"])
    for fn in (lambda k: rng.split(k, 3), lambda k: rng.random_bits(k, (4,)), rng.uniform,
               lambda k: rng.randint(k, (2,), 0, 2**31 - 1)):
        equal = equal and torch.equal(fn(on["cuda"]).cpu(), fn(on["cpu"]))
    draws = {dev: physics.draw_bounce_randoms(keys, sim.cfg.max_depth) for dev, keys in on.items()}
    for name in ("angle_u", "axis_u", "radius_u", "roulette_u"):
        equal = equal and torch.equal(draws["cuda"][name].cpu(), draws["cpu"][name])
    q_err = float((draws["cuda"]["q_normal"].cpu() - draws["cpu"]["q_normal"]).abs().max())
    q_ok = torch.allclose(draws["cuda"]["q_normal"].cpu(), draws["cpu"]["q_normal"],
                          rtol=NORMAL_RTOL, atol=NORMAL_ATOL)
    a, b = sim.render_frame(seed=31), sim.render_frame(seed=31)
    same = torch.equal(a["bmode"], b["bmode"]) and torch.equal(a["rf_raw"], b["rf_raw"])
    other = sim.render_frame(seed=32)["bmode"]
    print(f"[rng] card vs CPU: keys, bits, uniforms and integers equal {equal}; normal max abs "
          f"err {q_err:.3e} (rtol {NORMAL_RTOL}, atol {NORMAL_ATOL}) {q_ok}; render_frame(31) "
          f"twice equal {same}, render_frame(32) differs {not torch.equal(other, a['bmode'])}")
    if not (equal and q_ok and same) or torch.equal(other, a["bmode"]):
        raise AssertionError("keyed randomness: the card disagrees with the CPU or with itself")
    ms = cuda_ms(lambda: sim.draws(5), 10)
    print(f"  [{smi}] one frame's draws ({sim.cfg.max_depth} x {ids.numel()} x 5 fields): "
          f"{ms:.3f} ms")
    view = device_view("frame draws", lambda: sim.draws(5), ms, n=3, top=3)
    return {"draws_ms": ms, "draws_operations": view["operations"],
            "draws_busy_ms": view["busy_ms"]}


# every mode of the scatterer field at a 64-element sphere frame: normals x
# lookup x gate x volume side (a power of two and not), and the table texture
FIELD_MODES = [dict(scatter_rng=rng_mode, trilinear_texture=tri, soft_scattering=soft,
                    volume_size=size)
               for rng_mode in ("bitsum", "boxmuller") for tri in (False, True)
               for soft in (False, True) for size in (256, 48)] + [dict(texture_mode="table")]
# Box–Muller: the kernels' logf/sqrtf/cosf/sinf against the plain version's
# torch.log/sqrt/cos/sin on the card; a cell outside (rtol, atol) is a gate
# flip (hard gate, prob within rounding of mu1), at most FLIP_SHARE of them
BOXMULLER_RTOL, BOXMULLER_ATOL, FLIP_SHARE = 1e-4, 1e-5, 1e-3
# the modes the reference runs outside its kernels and the field modes K2/K8
# gained, each a frame on the card against the CPU
PLAIN_MODES = {"centered psf": {"centered_psf": True}, "hilbert": {"envelope_mode": "hilbert"},
               "soft row binning": {"soft_row_binning": True}, "table": {"texture_mode": "table"},
               "table + soft row binning": {"texture_mode": "table", "soft_row_binning": True},
               "box-muller": {"scatter_rng": "boxmuller"}, "volume 48": {"volume_size": 48}}
# the scatter march (soft row binning) sums a pixel's echoes in index_put_'s
# order: in turn on the CPU, sorted by index on the card (the same on every
# run there, not atomics); where echoes of both signs cancel, a cell near 0
# keeps their rounding (4.2e-5 at the small config), so an absolute bound
SCATTER_ATOL = 1e-4
TALL_ROWS = (1200, 2000)  # K3 past a lane's 31-row peak mask (992 rows), and past shared memory


def compare_march(label: str, soa, seeds, cfg, g) -> dict:
    """K2 and K8 against their plain versions on one SoA: K2 bitwise with
    bitsum normals, within the Box–Muller bounds (flips counted) otherwise;
    K8 per field within MARCH_BWD_TOL of the field's largest plain entry,
    outside the columns of a flipped cell. Returns the numbers."""
    n_cols = g.shape[1]
    got, want = march.march_forward(soa, seeds, cfg, n_cols), march.march_plain(soa, seeds, cfg, n_cols)
    err = float((got - want).abs().max())
    differing = int((got != want).sum())
    flips = int((~torch.isclose(got, want, rtol=BOXMULLER_RTOL, atol=BOXMULLER_ATOL)).sum())
    keep = torch.ones(n_cols, dtype=torch.bool, device=got.device)
    if cfg.scatter_rng == "bitsum":
        ok = differing == 0
    else:
        ok = flips <= FLIP_SHARE * got.numel()
        keep = torch.isclose(got, want, rtol=BOXMULLER_RTOL, atol=BOXMULLER_ATOL).all(dim=0)
    got_g = march.march_backward(soa, seeds, g, cfg)[:, :, :n_cols]
    want_g = march.march_bwd_plain(soa, seeds, g, cfg)[:, :, :n_cols]
    worst = 0.0
    for f in range(march.N_FIELDS):
        scale = float(want_g[:, f].abs().max())
        e = float((got_g[:, f] - want_g[:, f])[:, keep].abs().max())
        worst = max(worst, e / scale if scale else 0.0)
        ok = ok and e <= MARCH_BWD_TOL * scale
    ok = ok and float(want_g.abs().max()) > 0 and float(want.abs().max()) > 0
    print(f"  {label}: march {differing} differing cells of {got.numel()}, max abs err {err:.3e}, "
          f"{flips} outside rtol {BOXMULLER_RTOL} / atol {BOXMULLER_ATOL}; march_bwd worst field "
          f"err / max |plain| {worst:.3e} (limit {MARCH_BWD_TOL}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{label}: the march kernels disagree with their plain versions")
    return {"differing": differing, "max_abs_err": err, "flips": flips, "bwd_worst": worst}


def march_modes_phase(pack) -> dict:
    """K2 and K8 at a 64-element sphere frame in every FIELD_MODES mode."""
    print("[march modes] 64-element sphere frame; K2 bitwise with bitsum normals")
    out = {}
    for overrides in FIELD_MODES:
        cfg = small_test_config(**overrides)
        sim = Simulator(pack, cfg, device="cuda", seed=0)
        soa = sim.render_frame(1)["soa"]
        g = torch.randn((cfg.rf_rows, cfg.rf_cols), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(6))
        label = " ".join(f"{k}={v}" for k, v in overrides.items())
        out[label] = compare_march(label, soa, sim.seeds, cfg, g)
    return out


def plain_modes_phase(pack) -> None:
    """The modes the reference runs outside its kernels (plain torch on CUDA
    tensors where it leaves the kernel) and the field modes of K2 and K8,
    each a frame on the card against the CPU path, same draws, at the small
    config; the counts set to 0 just before each frame and read just after."""
    print("[plain modes] small config, card against CPU")
    for name, overrides in PLAIN_MODES.items():
        cfg = small_test_config(**overrides)
        cpu, gpu = (Simulator(pack, cfg, device=d, seed=5) for d in ("cpu", "cuda"))
        draws = cpu.draws(5)
        kernels.reset_launch_counts()
        on_gpu = gpu.render_frame(draws={k: v.cuda() for k, v in draws.items()})
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = {k: 0 for k in counts} | {"intersect_listed": cfg.max_depth, "scanconv": 1,
                                         "march": int(not cfg.soft_row_binning),
                                         "postproc": int(postproc.kernel_modes(cfg))}
        on_cpu = cpu.render_frame(draws=draws)
        atol = SCATTER_ATOL if cfg.soft_row_binning else 1e-5
        errs = {k: float((on_gpu[k].cpu() - on_cpu[k]).abs().max()) for k in ("rf_raw", "bmode")}
        ok = counts == want and all(torch.allclose(on_gpu[k].cpu(), on_cpu[k], rtol=1e-4, atol=atol)
                                    for k in ("rf_raw", "bmode"))
        again = gpu.render_frame(draws={k: v.cuda() for k, v in draws.items()})
        same = torch.equal(again["rf_raw"], on_gpu["rf_raw"])
        print(f"  {name}: launches {counts}; max abs err rf_raw {errs['rf_raw']:.3e}, bmode "
              f"{errs['bmode']:.3e} (rtol 1e-4, atol {atol}); rendered twice equal {same}")
        if not (ok and same):
            raise AssertionError(f"{name}: the card's frame disagrees with the CPU's")


def check_tall_images(cfg) -> dict:
    """K3 bitwise against its plain version on images of TALL_ROWS rows."""
    out = {}
    for rows in TALL_ROWS:
        g = torch.Generator().manual_seed(rows)
        rf = torch.randn((rows, 512), generator=g)
        rf[:, 7] = torch.linspace(1.0, -1.0, rows)
        rf[900:1100, 9] = 0.5
        rf = rf.cuda()
        got, want = postproc.postproc_forward(rf, cfg), postproc.postproc_plain(rf, cfg)
        slab = _build.library().mcray_postproc_slab_floats(rows, 512, 1, cfg.psf_lateral_size,
                                                           postproc.MAX_SHARED_BYTES)
        err = float((got - want).abs().max())
        out[rows] = {"max_abs_err": err, "device_ms": graph_ms(
            lambda r=rf: postproc.postproc_forward(r, cfg), 1), "slab_floats": slab}
        print(f"  postproc on a made-up {rows} x 512 image ({'device-memory slab' if slab else 'shared memory'}): "
              f"max abs err {err:.3e}, {int((got != want).sum())} differing; device "
              f"{out[rows]['device_ms']:.4f} ms")
        if not torch.equal(got, want):
            raise AssertionError(f"postproc at {rows} rows != plain")
    return out



def timed(fn):
    """(fn's result, its ms by CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def check_launches(label: str, counts: dict, per_run: dict, runs: int = 1) -> None:
    want = {k: per_run.get(k, 0) * runs for k in counts}
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")


def frame_launches(cfg, frames: int, closest: str = "intersect_listed") -> dict:
    return {closest: cfg.max_depth * frames, "march": frames, "postproc": frames,
            "scanconv": frames}


def pose_fd_phase(pack, smi: str) -> dict:
    """``PoseFitter(method="fd")`` at full width on the card: the 4-key
    compound target at the scene's pose, then POSE_FD_STEPS steps from the
    pose + POSE_OFFSET with keys split(prng_key(42), 4) and scales (2, 4, 8),
    each with the launch counts set to 0 just before it and read just after
    (its 28 frames are one batched pass: one launch of each kernel a step);
    then one more step under the profiler."""
    cfg = SimConfig()
    sim = Simulator(pack, cfg, device="cuda", seed=0)
    keys = rng.split(rng.prng_key(42), 4)
    with torch.no_grad():
        target = sim.render_compound(keys)
    check_bmode("pose target", sim, target)
    true = sim.position.cpu()
    start = true + torch.tensor(POSE_OFFSET)
    fit = PoseFitter.from_simulator(sim, start, sim.angles, target, method="fd", keys=keys)
    frames = (2 * 3 + 1) * len(keys)
    err0 = float(torch.linalg.norm(start - true))
    print(f"[pose fd] sphere, {len(keys)} keys, scales {fit.scales}, {POSE_FD_STEPS} steps from "
          f"the pose + {POSE_OFFSET} (error {err0:.4f}); {frames} frames a step")
    losses, step_ms = [], []
    for i in range(POSE_FD_STEPS):
        kernels.reset_launch_counts()
        (vals, g, delta), ms = timed(lambda i=i: fit.fd_step(i))
        counts = kernels.launch_counts()
        check_launches(f"pose fd step {i}", counts, frame_launches(cfg, 1))
        err = float(torch.linalg.norm(fit.position.cpu() - true))
        losses.append(float(vals[0]))
        step_ms.append(ms)
        print(f"  step {i}: loss {losses[-1]:.6g} |g| {float(torch.linalg.norm(g)):.4g} delta "
              f"{delta:.4f} position error {err:.4f}; {ms:.1f} ms")
    print(f"  launches per step: {counts}")
    if not all(map(math.isfinite, losses)) or not err < err0:
        raise AssertionError(f"pose fd: losses {losses} not finite, or the error {err} is not "
                             f"below the start's {err0}")
    med = statistics.median(step_ms)
    print(f"  [{smi}] fd step: median {med:.1f} ms (min {min(step_ms):.1f}, max "
          f"{max(step_ms):.1f}) over {POSE_FD_STEPS} steps, {med / frames:.2f} ms a frame")
    view = device_view("pose fd step", lambda: fit.fd_step(POSE_FD_STEPS), med, n=1,
                       expect={"intersect_listed_kernel": cfg.max_depth})
    return {"step_ms": step_ms, "busy_ms": view["busy_ms"], "operations": view["operations"],
            "counts": counts, "error": (err0, err), "losses": losses}


def pose_fd_cuda_vs_cpu(pack) -> None:
    """One fd step at a small config (32 x 1, 2 keys, scales 4 and 8) with the
    same keys: the 7 point losses and the gradient on the card against the CPU."""
    small = small_test_config(transducer_elements=32, samples_per_element=1)
    keys = rng.split(rng.prng_key(42), 2)
    result = {}
    for device in ("cpu", "cuda"):
        sim = Simulator(pack, small, device=device, seed=0)

        def render(key, position, angles, sim=sim):
            return sim.render_frame(key, position=position, angles=angles)["bmode"]

        with torch.no_grad():
            target = PoseFitter.compound(render, keys, sim.position, sim.angles)
        fit = PoseFitter.from_simulator(sim, sim.position.cpu() + torch.tensor(POSE_OFFSET),
                                        sim.angles, target, method="fd", keys=keys,
                                        scales=(4.0, 8.0), learning_rate=2.5e-2)
        vals, g, _ = fit.fd_step(0)
        result[device] = (vals.cpu(), g.cpu())
    (v_c, g_c), (v_g, g_g) = result["cpu"], result["cuda"]
    rel = float(((v_g - v_c).abs() / v_c.abs()).max())
    g_err = float((g_g - g_c).abs().max() / g_c.abs().max())
    print(f"[cuda vs cpu] pose fd step, small config: 7 point losses max rel err {rel:.3e} (limit "
          f"{POSE_LOSS_RTOL}); gradient max abs err / max |cpu| {g_err:.3e}")
    if not (rel <= POSE_LOSS_RTOL and bool(torch.isfinite(g_g).all())):
        raise AssertionError("the pose fd step on the card disagrees with the CPU")


def pose_ad_phase(pack, smi: str) -> dict:
    """``PoseFitter(method="ad", fit_angles=True)`` at full width in soft +
    trilinear mode: POSE_AD_STEPS steps from the pose + POSE_OFFSET against a
    frame at the scene's pose, one fixed key, counts set to 0 before each."""
    cfg = SimConfig(soft_scattering=True, trilinear_texture=True)
    sim = Simulator(pack, cfg, device="cuda", seed=0)
    key = rng.prng_key(3)
    with torch.no_grad():
        target = sim.render_frame(key)["bmode"]
    check_bmode("pose ad target", sim, target)
    start = sim.position.cpu() + torch.tensor(POSE_OFFSET)
    fit = PoseFitter.from_simulator(sim, start, sim.angles, target, method="ad", fixed_key=key,
                                    fit_angles=True, learning_rate=3e-2)
    per_step = frame_launches(cfg, 1) | {"march_bwd": 1, "scanconv_bwd": 1}
    print(f"[pose ad] sphere, soft + trilinear, position and angles, {POSE_AD_STEPS} steps")
    step_ms = []
    for i in range(POSE_AD_STEPS):
        kernels.reset_launch_counts()
        loss, ms = timed(lambda: fit.step(key))
        counts = kernels.launch_counts()
        check_launches(f"pose ad step {i}", counts, per_step)
        g = fit.last_grad
        step_ms.append(ms)
        print(f"  step {i}: loss {loss:.6g}; d/d(position) {g[:3].tolist()}, d/d(angles) "
              f"{g[3:].tolist()}; {ms:.1f} ms")
        if not (bool(torch.isfinite(g).all()) and float(g[:3].abs().max()) > 0
                and float(g[3:].abs().max()) > 0):
            raise AssertionError("pose ad: a gradient is not finite, or zero")
    print(f"  launches per step: {counts}")
    med = statistics.median(step_ms)
    print(f"  [{smi}] ad step: median {med:.1f} ms over {POSE_AD_STEPS} steps")
    view = device_view("pose ad step", lambda: fit.step(key), med, n=1,
                       expect={"intersect_listed_kernel": cfg.max_depth})
    return {"step_ms": step_ms, "busy_ms": view["busy_ms"], "operations": view["operations"],
            "counts": counts}


def pose_ad_cuda_vs_cpu(pack) -> None:
    """The pose gradient of one frame at a small soft + trilinear config with
    the same draws, from the pose + POSE_OFFSET: the loss and d/d(position,
    angles) on the card against the CPU."""
    small = small_test_config(transducer_elements=32, samples_per_element=1,
                              soft_scattering=True, trilinear_texture=True)
    draws = Simulator(pack, small, device="cpu", seed=0).draws(0)
    result = {}
    for device in ("cpu", "cuda"):
        sim = Simulator(pack, small, device=device, seed=0)
        d = {k: v.to(sim.device) for k, v in draws.items()}
        with torch.no_grad():
            target = sim.render_frame(draws=d)["bmode"]
        pos = (sim.position + torch.tensor(POSE_OFFSET, device=sim.device)).requires_grad_(True)
        ang = sim.angles.clone().requires_grad_(True)
        loss = torch.mean((sim.render_frame(position=pos, angles=ang, draws=d)["bmode"]
                           - target) ** 2)
        grads = torch.autograd.grad(loss, (pos, ang))
        result[device] = (float(loss.detach()), [g.cpu() for g in grads])
    (l_c, g_c), (l_g, g_g) = result["cpu"], result["cuda"]
    errs = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_g, g_c)]
    print(f"[cuda vs cpu] pose gradient, small soft + trilinear config: loss {l_g:.8g} vs "
          f"{l_c:.8g}; max abs err / max |cpu|: position {errs[0]:.3e}, angles {errs[1]:.3e} "
          f"(limits {POSE_LOSS_RTOL}, {POSE_GRAD_TOL})")
    if not (abs(l_g - l_c) <= POSE_LOSS_RTOL * abs(l_c) and max(errs) <= POSE_GRAD_TOL
            and all(float(g.abs().max()) > 0 for g in g_c)):
        raise AssertionError("the pose gradient on the card disagrees with the CPU")


def run_command(argv: list[str], stdin: str = "") -> list[str]:
    """``cli.main(argv)`` with ``stdin`` as its standard input; its output lines."""
    out, old = io.StringIO(), sys.stdin
    sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out):
            code = cli.main(argv)
    finally:
        sys.stdin = old
    if code != 0:
        raise AssertionError(f"{' '.join(argv[:1])}: exit code {code}")
    return out.getvalue().splitlines()


def read_bytes(path: str) -> bytes:
    """What ``save_png`` wrote (a PNG with pillow, else its PGM fallback)."""
    return open(path if os.path.exists(path) else f"{path}.pgm", "rb").read()


def serve_phase(sim, tmp: str) -> dict:
    """``serve`` at full width on 4 requests, one of them malformed, three
    poses: 3 frame lines and 1 error line, and the second request's PNG
    equal to ``save_png`` of ``render_frame`` at that request (``sim`` is the
    sphere's default ``Simulator``, as ``serve`` builds it)."""
    pos0, ang0 = sim.position.tolist(), sim.angles.tolist()
    moved = [pos0[0], pos0[1] + 0.3, pos0[2]]
    turned = [ang0[0], ang0[1], ang0[2] + 4.0]
    requests = [json.dumps({"seed": 11}), json.dumps({"seed": 12, "position": moved}),
                "{\"position\": [1.0, 2.0, ", json.dumps({"seed": 13, "angles": turned})]
    kernels.reset_launch_counts()
    lines = run_command(["serve", SPHERE_SCENE, "--out-prefix", os.path.join(tmp, "serve")],
                        "\n".join(requests) + "\n")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    replies = [json.loads(x) for x in lines]
    frames = [r for r in replies if "frame" in r]
    errors = [r for r in replies if "error" in r]
    print(f"[serve] sphere, {len(requests)} requests (one malformed): {replies[0]}; frame ms "
          f"{[f['ms'] for f in frames]}; {errors}")
    check_launches("serve", counts, frame_launches(sim.cfg, 4))  # a warm frame + 3
    if replies[0] != {"ready": True, "triangles": sim.pack.n_triangles} or len(frames) != 3 \
            or len(errors) != 1 or len(replies) != 5:
        raise AssertionError(f"serve replied {replies}")
    want = os.path.join(tmp, "want.png")
    save_png(want, sim.render_frame(12, position=moved)["bmode"].cpu().numpy())
    if read_bytes(frames[1]["out"]) != read_bytes(want):
        raise AssertionError("serve: the served PNG != save_png of render_frame at its request")
    print(f"  launches: {counts}; request 2's PNG equals save_png(render_frame(12, moved))")
    return {"frame_ms": [f["ms"] for f in frames], "counts": counts}


def sweep_phase(cfg, tmp: str) -> dict:
    kernels.reset_launch_counts()
    prefix = os.path.join(tmp, "sweep")
    lines = run_command(["sweep", SPHERE_SCENE, "--frames", str(SWEEP_FRAMES),
                         "--out-prefix", prefix])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"[sweep] sphere, {SWEEP_FRAMES} frames: " + "; ".join(lines))
    check_launches("sweep", counts, frame_launches(cfg, SWEEP_FRAMES))
    if len(lines) != SWEEP_FRAMES or not all(os.path.exists(f"{prefix}_{i:03d}.png")
                                             or os.path.exists(f"{prefix}_{i:03d}.png.pgm")
                                             for i in range(SWEEP_FRAMES)):
        raise AssertionError(f"sweep wrote {lines}")
    print(f"  launches: {counts}")
    return {"counts": counts}


def render_flags_phase(tmp: str) -> dict:
    """``render`` at full width with every flag the reference has: ``--bvh``
    (K11), ``--bug-compat``, ``--probe linear``, ``--envelope hilbert`` (plain
    torch on the card: no K3), ``--texture table``, ``--scatter-rng
    boxmuller``, ``--save-rf`` and ``--dump-column``."""
    cfg = SimConfig()
    rf = os.path.join(tmp, "rf.npz")
    kernels.reset_launch_counts()
    lines = run_command([SPHERE_SCENE, "--bvh", "--bug-compat", "--probe", "linear", "--envelope",
                         "hilbert", "--texture", "table", "--scatter-rng", "boxmuller",
                         "--save-rf", rf, "--dump-column", "256", "--out",
                         os.path.join(tmp, "flags.png")])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"[render flags] {lines[0]}; {lines[1]}")
    check_launches("render flags", counts, {"bvh_intersect": cfg.max_depth, "march": 1,
                                            "scanconv": 1})
    with np.load(rf) as saved:
        files = sorted(saved.files)
        finite = all(bool(np.isfinite(saved[k]).all()) for k in files)
    dump = lines[lines.index("RF column 256 (row: raw envelope):") + 1:]
    print(f"  launches: {counts}; npz {files}, finite {finite}; {len(dump)} dump lines")
    if "intersect bvh" not in lines[0] or files != ["bmode", "rf_env", "rf_raw"] or not finite \
            or len(dump) != cfg.rf_rows:
        raise AssertionError("render with every flag: wrong output")
    return {"counts": counts}


def bvh_compare(dbvh, rays, tri_soa) -> tuple[dict, tuple]:
    """K11 on one bounce's rays against its plain version (t bits, winner, the
    4-wide walk's counts), the binary walk and K1 (t bits, winner): the
    differing entries of each; the binary and 4-wide walks' (2, N) counts, and
    the binary walk's touched (nodes, triangles) masks."""
    t_k, j_k, c_k = bvh_intersect.bvh_best(rays, dbvh, counts=True)
    t_p, j_p, c_p = bvh.bvh4_best_plain(rays, dbvh, counts=True)
    t_b, j_b, c_b, touched = bvh.bvh_best_plain(rays, dbvh, counts=True, touched=True)
    t_1, i_1 = intersect.intersect_best(rays, tri_soa)
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    diff = {"plain": int((bits(t_k) != bits(t_p)).sum() + (j_k != j_p).sum() + (c_k != c_p).sum()),
            "binary": int((bits(t_k) != bits(t_b)).sum() + (j_k != j_b).sum()),
            "k1": int((bits(t_k) != bits(t_1)).sum() + (j_k != i_1).sum())}
    return diff, (c_b, c_p, touched)


def check_bvh(sims, outs, tri_soa, batch_rays) -> tuple[dict, dict]:
    """K11 at every bounce of the sphere, ircad_hd and mega bvh frames and of
    the sphere's bvh batch of 8 (``bvh_compare``), each bvh frame bitwise its
    brute frame (K1). Returns, by ray set, the binary walk of each bounce
    (``roofline.reference_walks``' form: its rays, counts and touched masks),
    and the 4-wide walk's counts of each bounce."""
    sets = {scene: (sims[f"{scene} bvh"].bvh, outs[f"{scene} bvh"]["segments"]["rays"],
                    tri_soa[scene]) for scene in BVH_SCENES}
    sets["batch"] = (sims["sphere bvh"].bvh, batch_rays, tri_soa["sphere"])
    walks, four_wide, failed = {}, {}, []
    for name, (dbvh, rays, soa) in sets.items():
        diff = {"plain": 0, "binary": 0, "k1": 0}
        walks[name], four_wide[name] = [], []
        for d in range(rays.shape[0]):
            q = rays[d].contiguous()
            got, (c_b, c_p, touched) = bvh_compare(dbvh, q, soa)
            diff = {k: diff[k] + got[k] for k in diff}
            walks[name].append((q, c_b, touched))
            four_wide[name].append(c_p)
        print(f"[bvh] bvh_intersect, {name} ({q.shape[1]} rays x {rays.shape[0]} bounces, 4-wide "
              f"depth {dbvh.depth}, stack need {dbvh.stack_need}): {diff['plain']} differing (t, "
              f"winner, counts) vs its plain version, {diff['binary']} (t, winner) vs the binary "
              f"walk, {diff['k1']} vs K1")
        if any(diff.values()):
            failed.append(name)
    for scene in BVH_SCENES:
        out, brute = outs[f"{scene} bvh"], outs[f"{scene} brute"]
        equal = {key: torch.equal(out["segments"][key], brute["segments"][key])
                 for key in ("rays", "valid", "to", "reflected")}
        equal["bmode"] = torch.equal(out["bmode"], brute["bmode"])
        print(f"[bvh] {scene} bvh frame equal to the brute frame: {equal}")
        if not all(equal.values()):
            failed.append(f"{scene} frame")
    if failed:
        raise AssertionError(f"bvh_intersect disagrees with its plain version, the binary walk or "
                             f"K1, or a bvh frame with its brute frame: {failed}")
    return walks, four_wide


def walk_means(walks, four_wide) -> dict[str, float]:
    """Nodes and triangles per live ray of the binary walk (``walks``) and the
    4-wide walk (its (2, N) counts a bounce)."""
    live = ref = four = 0
    for (rays, ref_counts, _), counts in zip(walks, four_wide):
        alive = rays[3:6].abs().sum(dim=0) > 0
        live += int(alive.sum())
        ref = ref + ref_counts[:, alive].sum(dim=1).double()
        four = four + counts[:, alive].sum(dim=1).double()
    (r_nodes, r_tests), (f_nodes, f_tests) = (ref / live).tolist(), (four / live).tolist()
    return {"live_rays": live, "binary_pops": r_nodes, "binary_tests": r_tests,
            "four_wide_nodes": f_nodes, "four_wide_tests": f_tests}


def roofline_phase(sims, outs, walks, smi: str) -> dict:
    """The stage table of each of ROOFLINE_FRAMES beside the card's name and
    power limit: each stage's busy ms against its floor
    (``roofline.frame_costs``), the frame's busy ms, median, idle share and
    device operations. The trace floor reads the ``[bvh]`` phase's reference
    walks where they are of the frame's rays, else it walks them: for a
    single frame (seed 0, the ``[path]`` frames' seed) the path-bounces whose
    rays differ from those walks' are counted (the cluster kernels break an
    equal-t tie by cluster slot, K1 and K11 by triangle index, so a listed
    frame can send a path on from another triangle). The mega listed frame
    must trace the mega bvh frame's rays, and so have its trace floor."""
    tables, differing = {}, {}
    for label, (name, seeds, ray_set) in ROOFLINE_FRAMES.items():
        t0 = time.perf_counter()
        bvh_sim = sims["sphere bvh" if ray_set == "batch" else f"{ray_set} bvh"]
        tables[label] = roofline.stage_table(sims[name], seeds, walks[ray_set], bvh_sim.bvh)
        print("[roofline] " + roofline.to_markdown(tables[label], f"{label}; {smi}"))
        note = "of the [bvh] phase" if tables[label]["walks_reused"] else "walked here"
        if len(seeds) == 1:
            rays = outs[name]["segments"]["rays"]
            differing[label] = sum(int((w[0] != rays[d]).any(dim=0).sum())
                                   for d, w in enumerate(walks[ray_set]))
            note += (f"; {differing[label]} of {rays.shape[0] * rays.shape[2]} path-bounces' rays "
                     f"differ from the [bvh] phase's {ray_set} frame")
        print(f"  {time.perf_counter() - t0:.1f} s; the reference walks {note}")
    floors = {label: next((r["n_ops"], r["n_bytes"]) for r in tables[label]["stages"]
                          if r["stage"] == "trace") for label in ("mega listed", "mega bvh")}
    print(f"[roofline] trace floor (operations, bytes): mega listed {floors['mega listed']}, "
          f"mega bvh {floors['mega bvh']}")
    if differing["mega listed"] or floors["mega listed"] != floors["mega bvh"]:
        raise AssertionError("the mega listed frame does not trace the mega bvh frame's rays, or "
                             "their trace floors differ")
    print("[roofline] summary: " + json.dumps(tables))
    return tables


def nonzero(counts: dict[str, int]) -> dict[str, int]:
    return {k: v for k, v in counts.items() if v}


def shard_phase(pack, sim, fit, smi: str) -> dict:
    """The parallel layer on a one-rank NCCL group (``make_mesh(device="cuda")``
    starts it on a free local port): the scanline-sharded sphere frame at
    ``SimConfig()`` in both imaging modes and the 1 x 1 2-D mesh against the
    ``Simulator`` (RF bitwise; the gathered B-mode bitwise, the same K3; the
    halo B-mode at rtol 1e-5 / atol 1e-6, the plain postproc against K3),
    one sharded train step at the ``[fit]`` set-up against ``MaterialFitter``
    (loss rtol 1e-4, gradient 2e-3 of its largest entry), exact launch
    counts for each, then the sharded frames timed and profiled beside the
    single device's. One card holds one NCCL rank: more ranks are checked
    on the CPU by gloo (``tests/test_torch_shard.py``)."""
    cfg = sim.cfg
    mesh = make_mesh(device="cuda")
    try:
        print(f"[shard] one-rank {dist.get_backend()} group (world {dist.get_world_size()}), NCCL "
              f"{torch.cuda.nccl.version()}; sphere at SimConfig(), frames 0-{SHARD_FRAMES - 1}")
        frame_launches = {"intersect_listed": cfg.max_depth, "march": 1, "scanconv": 1}
        renderers = {"halo": ShardedRenderer(pack, cfg, mesh, distributed_imaging=True),
                     "gathered": ShardedRenderer(pack, cfg, mesh, distributed_imaging=False),
                     "2d 1x1": ShardedRenderer2D(pack, cfg, make_mesh_2d(1, 1, device="cuda"))}
        launches = {}
        for mode, renderer in renderers.items():
            per_frame = frame_launches | ({"postproc": 1} if mode == "gathered" else {})
            for seed in range(SHARD_FRAMES if mode != "2d 1x1" else 1):
                want = sim.render_frame(seed)
                kernels.reset_launch_counts()
                got = renderer.render_frame(seed)
                torch.cuda.synchronize()
                launches[mode] = kernels.launch_counts()
                check_launches(f"sharded {mode} frame {seed}", launches[mode], per_frame)
                rf_equal = torch.equal(got["rf_raw"], want["rf_raw"])
                bm_err = float((got["bmode"] - want["bmode"]).abs().max())
                bm_ok = (torch.equal(got["bmode"], want["bmode"]) if mode == "gathered" else
                         torch.allclose(got["bmode"], want["bmode"], rtol=1e-5, atol=1e-6))
                print(f"  {mode} frame {seed}: rf_raw bitwise {rf_equal}, bmode max err {bm_err:.3e}"
                      f" ({'bitwise' if mode == 'gathered' else 'rtol 1e-5, atol 1e-6'}) "
                      f"{'ok' if bm_ok else 'FAILED'}")
                if not (rf_equal and bm_ok):
                    raise AssertionError(f"the sharded {mode} frame {seed} != the Simulator's")
                check_bmode(f"sharded {mode} frame {seed}", sim, got["bmode"])
            print(f"  launches a {mode} frame: {nonzero(launches[mode])}")

        # one train step at the [fit] set-up against MaterialFitter on the card
        row, col = 3, physics.ATTENUATION
        fit_sim, target = fit["sim"], fit["frame"]["bmode"]
        perturbed = pack.materials.copy()
        perturbed[row, col] *= 2.0
        draws = fit_sim.draws(0)
        fitter = MaterialFitter.from_simulator(fit_sim, perturbed, target, trainable=(col,),
                                               trainable_rows=[row], fixed_frame=draws)
        want_loss = fitter.step(draws)
        want_grad = fitter.last_grad
        step = ShardedRenderer(pack, fit["cfg"], mesh).make_train_step(
            1e-2, column_mask(perturbed.shape[0], (col,), [row]), perturbed)
        kernels.reset_launch_counts()
        loss = step(rng.fold_in(rng.prng_key(0), 0), target)
        torch.cuda.synchronize()
        launches["train step"] = kernels.launch_counts()
        check_launches("sharded train step", launches["train step"],
                       frame_launches | {"march_bwd": 1, "scanconv_bwd": 1})
        grad_err = float((step.last_grad - want_grad).abs().max())
        scale = float(want_grad.abs().max())
        print(f"  train step: loss {loss:.8g} vs MaterialFitter {want_loss:.8g}; gradient max err "
              f"{grad_err:.3e} of its largest entry {scale:.3e}; launches "
              f"{nonzero(launches['train step'])}")
        if not (math.isclose(loss, want_loss, rel_tol=1e-4) and scale > 0
                and grad_err <= 2e-3 * scale):
            raise AssertionError("the sharded train step != MaterialFitter's")

        # timing: the sharded frames beside the single device's, in turns
        print(f"  [{smi}] timing, {SHARD_TIMED_FRAMES} frames each by events")
        timed_ms, views = {}, {}
        for name, render in (("single", sim.render_frame),
                             ("gathered", renderers["gathered"].render_frame),
                             ("halo", renderers["halo"].render_frame)):
            seeds = iter(range(200, 200 + SHARD_TIMED_FRAMES))
            ms = event_ms(lambda: render(next(seeds)), SHARD_TIMED_FRAMES)
            timed_ms[name] = {"median": statistics.median(ms), "min": min(ms), "max": max(ms)}
            print(f"  {name} frame: median {timed_ms[name]['median']:.3f} ms (min "
                  f"{timed_ms[name]['min']:.3f}, max {timed_ms[name]['max']:.3f})")
            views[name] = device_view(f"{name} frame", lambda: render(7), timed_ms[name]["median"],
                                      expect={"intersect_listed_kernel": cfg.max_depth})
    finally:
        dist.destroy_process_group()
    return {"launches": launches, "ms": timed_ms,
            "busy_ms": {k: v["busy_ms"] for k, v in views.items()},
            "operations": {k: v["operations"] for k, v in views.items()}}


def batch_phase(pack, sim, fit, smi: str) -> dict:
    """The batched frame at ``SimConfig()`` (``Simulator.render_frames``: every
    stage, and every kernel launch, once for all B frames), each set-up with
    the launch counts set to 0 just before it and read just after:

    - ``render_frames`` of BATCH_SEEDS (``bench.py``'s batch of 8 seeds):
      rf_raw, rf_env and bmode bitwise against 8 ``render_frame`` calls,
      ``render_batch`` bitwise its bmode; K5 10, K2 1, K3 1, K4 1;
    - the pose fd step at the ``[pose fd]`` set-up (7 points x 4 keys = 28
      frames) through ``PoseFitter.from_simulator`` against a fitter given
      only the per-frame render (the points one after another): point
      losses, gradient and the updated pose bitwise; K5 10, K2 1, K3 1, K4 1;
    - a ``MaterialFitter`` step with BATCH_FIT_FRAMES frames at the ``[fit]``
      set-up against the same fitter rendering its frames one after another:
      the loss bitwise, the gradient within FIT_BATCH_GRAD_TOL of its largest
      entry (another summation order of the frames' contributions, and the
      card's gather backward adds with atomics); K5 10, K2 1, K3 1, K4 1, K8 1,
      K9 1;
    - the mega listed scene's batch of 8, bitwise 8 frames, and its peak memory.

    Then each set-up timed by events beside its loop, its device view (busy
    ms, idle share, operations) and its peak ``torch.cuda.max_memory_allocated``;
    and the batch's kernels at the batch's shapes: device ms by graph replay,
    ms by events, and the bound of this run's inputs."""
    cfg = sim.cfg
    seeds = list(BATCH_SEEDS)
    n = len(seeds)
    per_batch = frame_launches(cfg, 1)
    result = {"launches": {}, "ms": {}, "loop_ms": {}, "busy_ms": {}, "operations": {},
              "peak_mib": {}}

    def launched(label: str, fn, per_run: dict):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        check_launches(label, counts, per_run)
        result["launches"][label] = counts
        result["peak_mib"][label] = torch.cuda.max_memory_allocated() / 2**20
        print(f"  {label}: launches {nonzero(counts)}; peak memory allocated "
              f"{result['peak_mib'][label]:.1f} MiB")
        return out

    # 1. the 8-seed batch against 8 frames
    print(f"[batch] sphere at SimConfig(): render_frames of seeds {seeds}")
    out = launched("render_batch_8", lambda: sim.render_frames(seeds), per_batch)
    singles = [sim.render_frame(s) for s in seeds]
    for key in ("rf_raw", "rf_env", "bmode"):
        differing = [b for b in range(n) if not torch.equal(out[key][b], singles[b][key])]
        print(f"  {key} {tuple(out[key].shape)}: frames differing from render_frame: {differing}")
        if differing:
            raise AssertionError(f"batched {key} != render_frame's in frames {differing}")
    for b in range(n):
        check_bmode(f"batch frame {b}", sim, out["bmode"][b])
    if not torch.equal(sim.render_batch(seeds), out["bmode"]):
        raise AssertionError("render_batch != render_frames' bmode")
    if not torch.equal(sim.render_compound(seeds), out["bmode"].mean(dim=0)):
        raise AssertionError("render_compound != the mean of the batch")

    # 2. the pose fd step: 28 frames in one batched call against 28 one after another
    keys = rng.split(rng.prng_key(42), 4)
    with torch.no_grad():
        target = sim.render_compound(keys)
    start = sim.position.cpu() + torch.tensor(POSE_OFFSET)

    def render(key, position, angles):
        return sim.render_frame(key, position=position, angles=angles)["bmode"]

    def fitters():
        return (PoseFitter.from_simulator(sim, start, sim.angles, target, method="fd", keys=keys),
                PoseFitter(render, start.cuda(), sim.angles, target, method="fd", keys=keys))

    batched, looped = fitters()
    got = launched("pose_fd_step", lambda: batched.fd_step(0), per_batch)
    want = looped.fd_step(0)
    same = [torch.equal(a, b) for a, b in zip(got[:2], want[:2])]
    same.append(torch.equal(batched.position, looped.position))
    print(f"  pose fd step, 28 frames: point losses, gradient, pose bitwise the loop's: {same}")
    if not all(same):
        raise AssertionError("the batched pose fd step != the per-point loop")

    # 3. the fit step with BATCH_FIT_FRAMES frames against its loop
    row, col = 3, physics.ATTENUATION
    fit_sim, fit_target = fit["sim"], fit["frame"]["bmode"]
    perturbed = pack.materials.copy()
    perturbed[row, col] *= 2.0
    fit_kw = dict(trainable=(col,), trainable_rows=[row], n_frames_per_step=BATCH_FIT_FRAMES)

    def fit_fitters():
        def render_fn(key, materials):
            return fit_sim.render_frame(key, materials)["bmode"]

        init = torch.as_tensor(perturbed, device="cuda")
        return (MaterialFitter.from_simulator(fit_sim, perturbed, fit_target, **fit_kw),
                MaterialFitter(render_fn, init, fit_target, **fit_kw))

    fit_key = rng.prng_key(9)
    fit_batched, fit_looped = fit_fitters()
    loss = launched(f"fit_step_{BATCH_FIT_FRAMES}_frames", lambda: fit_batched.step(fit_key),
                    per_batch | {"march_bwd": 1, "scanconv_bwd": 1})
    want_loss = fit_looped.step(fit_key)
    grad, want_grad = fit_batched.last_grad, fit_looped.last_grad
    grad_err, scale = float((grad - want_grad).abs().max()), float(want_grad.abs().max())
    print(f"  fit step, {BATCH_FIT_FRAMES} frames: loss {loss!r} vs the loop's {want_loss!r}; "
          f"gradient max err {grad_err:.3e} of its largest entry {scale:.3e} (limit "
          f"{FIT_BATCH_GRAD_TOL} of it)")
    if not (loss == want_loss and scale > 0 and grad_err <= FIT_BATCH_GRAD_TOL * scale):
        raise AssertionError("the batched fit step != the loop's")
    result["fit_grad_err"] = grad_err / scale

    # timing by events, each set-up beside its loop, then the device's view
    print(f"  [{smi}] timing by events")
    first_seeds = iter(range(300, 300 + 100 * n, n))

    def fresh_seeds():
        s0 = next(first_seeds)
        return list(range(s0, s0 + n))

    fd_batched, fd_looped = fitters()
    timings = {
        "render_batch_8": (lambda: sim.render_batch(fresh_seeds()),
                           lambda: [sim.render_frame(s) for s in fresh_seeds()], BATCH_TIMED, 3),
        "pose_fd_step": (lambda: fd_batched.fd_step(0), lambda: fd_looped.fd_step(0), 5, 2),
        f"fit_step_{BATCH_FIT_FRAMES}_frames": (lambda: fit_batched.step(fit_key),
                                                lambda: fit_looped.step(fit_key), 5, 3),
    }
    for label, (fn, loop_fn, reps, loop_reps) in timings.items():
        ms = event_ms(fn, reps)
        loop_ms = event_ms(loop_fn, loop_reps)
        result["ms"][label] = {"median": statistics.median(ms), "min": min(ms), "max": max(ms)}
        result["loop_ms"][label] = {"median": statistics.median(loop_ms), "min": min(loop_ms),
                                    "max": max(loop_ms)}
        print(f"  {label}: batched median {statistics.median(ms):.3f} ms (min {min(ms):.3f}, max "
              f"{max(ms):.3f}) over {reps}; the loop {statistics.median(loop_ms):.3f} ms (min "
              f"{min(loop_ms):.3f}, max {max(loop_ms):.3f}) over {loop_reps}")
        view = device_view(f"{label} (batched)", fn, result["ms"][label]["median"], n=1,
                           expect={"intersect_listed_kernel": cfg.max_depth})
        result["busy_ms"][label], result["operations"][label] = view["busy_ms"], view["operations"]

    # the batch's kernels at the batch's shapes (8 frames; K8 and K9 at the fit's 4)
    maps = sim.scan_maps
    calls = [cluster_call("listed", r[0:3].T.contiguous(), r[3:6].T.contiguous(),
                          sim.culled_tris[0], sim.intersect_tile_r)
             for r in out["segments"]["rays"]]
    n_cols = n * cfg.rf_cols
    with torch.no_grad():
        fit_out = fit_sim.render_frames(rng.split(fit_key, BATCH_FIT_FRAMES),
                                        fit_batched.state.materials)
    fit_soa, fit_cols = fit_out["soa"], BATCH_FIT_FRAMES * cfg.rf_cols
    gen = torch.Generator(device="cuda").manual_seed(11)
    g_rf = torch.randn((cfg.rf_rows, fit_cols), device="cuda", generator=gen)
    g_bm = torch.randn((BATCH_FIT_FRAMES, cfg.bmode_rows, cfg.bmode_cols), device="cuda",
                       generator=gen)
    fns = {
        "intersect_listed": (lambda: [k(*a) for k, _, a in calls], cfg.max_depth,
                             cluster_bound(sim, calls)),
        "march": (lambda: march.march_forward(out["soa"], sim.seeds, cfg, n_cols), 1,
                  roofline.march_cost(out["soa"], cfg, n_cols).floor()),
        "postproc": (lambda: postproc.postproc_forward(out["rf_raw"], cfg), 1,
                     roofline.postproc_cost(cfg, n).floor()),
        "scanconv": (lambda: scanconv.scan_convert_forward(out["rf_env"], maps), 1,
                     roofline.scanconv_cost(cfg, n).floor()),
        "march_bwd": (lambda: march.march_backward(fit_soa, fit_sim.seeds, g_rf, fit["cfg"]), 1,
                      roofline.march_bwd_cost(fit_soa, fit["cfg"], fit_cols).floor()),
        "scanconv_bwd": (lambda: scanconv.scan_convert_backward(g_bm, maps), 1,
                         roofline.scanconv_bwd_cost(cfg, maps.pixel.numel(),
                                                    BATCH_FIT_FRAMES).floor()),
    }
    kernel_numbers = {}
    for name, (fn, per_call, (b_ms, b_by)) in fns.items():
        fn()
        mod = getattr(kernels, name.removesuffix("_bwd"))
        blocks = mod.last_blocks_bwd if name.endswith("_bwd") else mod.last_blocks
        kernel_numbers[name] = {"ms": cuda_ms(fn, 5) / per_call,
                                "device_ms": graph_ms(fn, per_call), "bound_ms": b_ms,
                                "bound_by": b_by, "blocks": blocks,
                                "frames": BATCH_FIT_FRAMES if name.endswith("_bwd") else n}
        print(f"  {name} at the batch's shapes ({kernel_numbers[name]['frames']} frames): "
              f"{kernel_numbers[name]['ms']:.4f} ms by events, device "
              f"{kernel_numbers[name]['device_ms']:.5f} ms per launch, bound {b_ms:.5f} ms by "
              f"{b_by}, {blocks} blocks")
    # what laying the wide (rf_rows, B x E) image out as (B, rf_rows, E) costs: one permuted copy
    wide = march.march_forward(out["soa"], sim.seeds, cfg, n_cols)
    copy_ms = graph_ms(
        lambda: wide.reshape(cfg.rf_rows, n, cfg.rf_cols).transpose(0, 1).contiguous(), 1)
    result["layout_copy"] = {"device_ms": copy_ms, "bound_ms": roofline.copy_bound(wide)[0]}
    print(f"  the wide image's permuted copy to (B, rows, E), {roofline.nbytes(wide)} bytes: device "
          f"{copy_ms:.5f} ms, bound {result['layout_copy']['bound_ms']:.5f} ms by bytes")
    # K3, K4 and K9 with the frame axis against their plain versions on these frames
    k3 = postproc.postproc_forward(out["rf_raw"], cfg)
    k3_each = torch.stack([postproc.postproc_forward(out["rf_raw"][b], cfg) for b in range(n)])
    k4 = scanconv.scan_convert_forward(out["rf_env"], maps)
    k9 = scanconv.scan_convert_backward(g_bm, maps)
    k9_each = torch.stack([scanconv.scan_convert_backward(g_bm[b], maps)
                           for b in range(BATCH_FIT_FRAMES)])
    checks = {
        "postproc frames == per-frame launches": torch.equal(k3, k3_each),
        "scanconv == plain": torch.equal(k4, scanconv.scan_convert_coords_plain(out["rf_env"],
                                                                               maps.coords)),
        "scanconv_bwd frames == per-frame launches": torch.equal(k9, k9_each),
    }
    k3_err = float((k3 - postproc.postproc_plain(out["rf_raw"], cfg)).abs().max())
    print(f"  frame axis: {checks}; postproc vs plain max abs err {k3_err:.3e}")
    if not all(checks.values()) or not torch.allclose(
            k3, postproc.postproc_plain(out["rf_raw"], cfg), *TOLERANCES["postproc"]):
        raise AssertionError("a kernel with the frame axis disagrees")
    check_close("scanconv_bwd", k9, scanconv.scan_convert_bwd_plain(
        g_bm, maps.table, cfg.rf_rows, cfg.rf_cols))
    result["kernels"] = kernel_numbers
    return result


def mega_batch_phase(sim) -> dict:
    """The mega listed scene's batch of BATCH_SEEDS: its launches, bmode
    bitwise 8 ``render_frame`` calls, the peak memory of the batch (the dense
    prepass tables grow with the rays), and its time by events beside the loop."""
    cfg = sim.cfg
    seeds = list(BATCH_SEEDS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = sim.render_batch(seeds)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check_launches("mega listed batch of 8", counts, frame_launches(cfg, 1))
    peak = torch.cuda.max_memory_allocated() / 2**20
    differing = [b for b, s in enumerate(seeds)
                 if not torch.equal(out[b], sim.render_frame(s)["bmode"])]
    ms = event_ms(lambda: sim.render_batch(seeds), 3)
    loop_ms = event_ms(lambda: [sim.render_frame(s) for s in seeds], 2)
    print(f"[batch] mega listed, seeds {seeds}: launches {nonzero(counts)}; bmode frames differing "
          f"from render_frame {differing}; peak memory allocated {peak:.1f} MiB; batched "
          f"{statistics.median(ms):.3f} ms (min {min(ms):.3f}), the loop "
          f"{statistics.median(loop_ms):.3f} ms")
    if differing:
        raise AssertionError(f"the mega batch != render_frame in frames {differing}")
    return {"peak_mib": peak, "ms": statistics.median(ms), "loop_ms": statistics.median(loop_ms),
            "launches": counts}


def bvh_batch_phase(sim) -> dict:
    """The sphere's batch of BATCH_SEEDS by BVH traversal: its launches (K11
    10 in all), every frame bitwise its ``render_frame`` (the segments' rays,
    valid, to and reflected, rf_raw, rf_env and bmode); its rays for K11."""
    cfg = sim.cfg
    seeds = list(BATCH_SEEDS)
    kernels.reset_launch_counts()
    out = sim.render_frames(seeds)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check_launches("sphere bvh batch of 8", counts, {"bvh_intersect": cfg.max_depth, "march": 1,
                                                     "postproc": 1, "scanconv": 1})
    singles = [sim.render_frame(s) for s in seeds]
    n = singles[0]["segments"]["valid"].shape[1]  # paths a frame
    differing = {}
    for key in ("rays", "valid", "to", "reflected"):
        dim = 2 if key == "rays" else 1
        differing[key] = [b for b, f in enumerate(singles) if not torch.equal(
            out["segments"][key].narrow(dim, b * n, n), f["segments"][key])]
    for key in ("rf_raw", "rf_env", "bmode"):
        differing[key] = [b for b, f in enumerate(singles) if not torch.equal(out[key][b], f[key])]
    print(f"[batch] sphere bvh, seeds {seeds}: launches {nonzero(counts)}; frames differing from "
          f"render_frame: {differing}")
    if any(differing.values()):
        raise AssertionError(f"the bvh batch != render_frame: {differing}")
    return {"launches": counts, "rays": out["segments"]["rays"]}


T_START = time.perf_counter()


def whole_chain_graph(sim, batch: int, n_chain: int):
    """The other graph design, measured beside the library's: all n_chain
    steps of a chained batch captured into one CUDA graph (after an eager
    warm-up step on a side stream), replayed once a call. Returns
    (call(seed0) -> the last step's B-modes, capture ms)."""
    steps = sim.make_chained_batch(batch, n_chain)
    t0 = time.perf_counter()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        steps.step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n_chain):
            out = steps.step()
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3

    def call(seed0):
        steps.key.copy_(rng.prng_key(seed0))
        steps.i.zero_()
        steps.carry.zero_()
        graph.replay()
        return out

    return call, capture_ms


def chained_phase(sims, smi: str) -> dict:
    """``Simulator.make_chained_batch`` at ``SimConfig()`` on the sphere (8 x
    16, ``bench.py``'s and ``bench_torch.py``'s) and on ircad_hd (8 x 8): one
    step captured as a CUDA graph, replayed n_chain times. The first call
    (the warm-up step, the capture, the replays) is driven with the launch
    counts set to 0 just before it and read just after (the warm-up step and
    n_chain replays: n_chain + 1 steps); its last step must be bitwise
    ``render_frames`` of its keys run eagerly, ``carry`` 0 after it and every
    frame a good B-mode. Then, per scene: capture ms and graph memory (the
    device memory the graph's pool keeps, after ``empty_cache``) of the
    chained call and of the whole chain in one graph (``whole_chain_graph``);
    both and the same n_chain steps run eagerly one after another timed by
    events in turns (graph, chain graph, eager, eager, chain graph, graph),
    wall ms per frame, all three bitwise alike; the device's view (busy ms,
    operations, idle share) of one chained call and of the eager steps, the
    chained call's launches by kernel name from the profiler (n_chain times
    a step's: K5 10, K2, K3, K4 1)."""
    result = {}
    for name, (batch, n_chain) in CHAINED.items():
        sim = sims[name]
        cfg = sim.cfg
        frames = batch * n_chain
        per_step = frame_launches(cfg, 1)
        expect = {roofline.EVENT_NAMES[k]: v * n_chain for k, v in per_step.items()}
        print(f"[chained] {name}: make_chained_batch({batch}, {n_chain}), {frames} frames a call")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        chained = sim.make_chained_batch(batch, n_chain)
        kernels.reset_launch_counts()
        last = chained(CHAINED_SEED)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        check_launches(f"[chained] {name} first call", counts, per_step, runs=n_chain + 1)
        capture_ms = profiling.last_ms("chained.capture")
        torch.cuda.empty_cache()
        graph_mib = (torch.cuda.memory_reserved() - reserved) / 2**20
        keys = rng.fold_in(rng.prng_key(CHAINED_SEED),
                           (n_chain - 1) * batch + torch.arange(batch, dtype=torch.int64))
        eager = sim.render_frames(keys)["bmode"]
        same = torch.equal(last, eager)
        print(f"  capture {capture_ms:.1f} ms (with the warm-up step), graph memory "
              f"{graph_mib:.1f} MiB; launches at the first call {nonzero(counts)}; last step "
              f"bitwise render_frames of its keys: {same}; carry {int(chained.carry)}, i "
              f"{int(chained.i)}")
        if not same or int(chained.carry) != 0 or int(chained.i) != n_chain:
            raise AssertionError(f"[chained] {name}: the last step differs from render_frames "
                                 "of its keys")
        for b in range(batch):
            check_bmode(f"{name} chained frame {b}", sim, last[b])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        chain_call, chain_capture_ms = whole_chain_graph(sim, batch, n_chain)
        chain_call(CHAINED_SEED)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        chain_mib = (torch.cuda.memory_reserved() - reserved) / 2**20
        print(f"  the whole chain one graph: capture {chain_capture_ms:.1f} ms (with the warm-up "
              f"step), graph memory {chain_mib:.1f} MiB")
        row = {"batch": batch, "n_chain": n_chain,
               "graph": {"capture_ms": capture_ms, "graph_mib": graph_mib,
                         "first_call_launches": nonzero(counts)},
               "chain_graph": {"capture_ms": chain_capture_ms, "graph_mib": chain_mib},
               "eager": {}}

        steps = sim.make_chained_batch(batch, n_chain)  # its steps, one by one, no graph

        def eager_call(seed0):
            steps.key.copy_(rng.prng_key(seed0))
            steps.i.zero_()
            steps.carry.zero_()
            for _ in range(n_chain):
                out = steps.step()
            return out

        calls = {"graph": lambda: chained(CHAINED_SEED + 1),
                 "chain_graph": lambda: chain_call(CHAINED_SEED + 1),
                 "eager": lambda: eager_call(CHAINED_SEED + 1)}
        ms = {k: [] for k in calls}
        for k in ("graph", "chain_graph", "eager", "eager", "chain_graph", "graph"):
            ms[k] += event_ms(calls[k], 1)
        if not (torch.equal(chained.out, calls["chain_graph"]())
                and torch.equal(chained.out, eager_call(CHAINED_SEED + 1))):
            raise AssertionError(f"[chained] {name}: the two graphs and the eager steps differ")
        for k, v in ms.items():
            row[k]["ms"] = v
            print(f"  {k}: {statistics.mean(v):.3f} ms a call (in turns: {v}), "
                  f"{statistics.mean(v) / frames:.4f} ms a frame")
        for k, label in (("graph", "chained call"), ("eager", "eager steps")):
            view = device_view(label, calls[k], statistics.mean(ms[k]), n=1, expect=expect)
            launched = {e: sum(c for kernel, c in view["count_by_name"].items() if e in kernel)
                        for e in expect}
            print(f"    launches by kernel name: {launched} (expected {expect}); per frame: busy "
                  f"{view['busy_ms'] / frames:.4f} ms, {view['operations'] / frames:.1f} "
                  f"operations")
            row[k].update({"busy_ms": view["busy_ms"], "operations": view["operations"],
                           "idle_share": 1.0 - view["busy_ms"] / statistics.mean(ms[k]),
                           "launches_by_name": launched})
        result[name] = row
        del chained, chain_call, steps
        torch.cuda.empty_cache()
    print(f"[chained] summary ({smi}): " + json.dumps(result))
    return result


def mark(label: str) -> None:
    """The run's elapsed seconds at the end of a phase."""
    print(f"[elapsed] {time.perf_counter() - T_START:.1f} s after {label}")


def main() -> int:
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU")
    smi = nvidia_smi()
    print(f"gpu: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. build
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s -> {_build.library_path()}")
    for line in _build.build_log().splitlines():
        if "registers" in line or line.startswith("# ") and " -c " not in line:
            print(f"  {line.strip()}")

    cfg = SimConfig()
    loop = {"march": 1, "postproc": 1, "scanconv": 1}
    how = "native library" if get_native() is not None else "Python"
    print(f"[scenes] BVH construction: {how}; OBJ parsing: {how}; {cfg.transducer_elements} elements x "
          f"{cfg.samples_per_element} paths x {cfg.max_depth} bounces")
    packs = {}
    for name, scene, assets in (("sphere", SPHERE_SCENE, None),
                                ("ircad_hd", IRCAD_HD_SCENE, IRCAD_HD_ASSETS),
                                ("mega", MEGA_SCENE, MEGA_ASSETS)):
        t0 = time.perf_counter()
        packs[name] = load_and_compile(scene, asset_dir=assets)
        print(f"  {name}: {packs[name].n_triangles} triangles (meshes, parse and BVH "
              f"{time.perf_counter() - t0:.1f} s)")
    sphere, ircad, mega = packs["sphere"], packs["ircad_hd"], packs["mega"]
    if ircad.n_triangles != 123_224 or mega.n_triangles != 615_176:
        raise AssertionError(f"ircad_hd has {ircad.n_triangles}, mega {mega.n_triangles} triangles")

    mark("build and scenes")
    # 2. the paths, each driven with the counts set to 0 just before it
    sims = {
        "sphere": Simulator(sphere, cfg, device="cuda", seed=0),
        "sphere brute": Simulator(sphere, cfg, device="cuda", seed=0, use_culled_intersect=False),
        "sphere bvh": Simulator(sphere, cfg, device="cuda", seed=0, use_bvh=True),
        "ircad_hd": Simulator(ircad, cfg, device="cuda", seed=0),
        "ircad_hd bvh": Simulator(ircad, cfg, device="cuda", seed=0, use_bvh=True),
        "ircad_hd brute": Simulator(ircad, cfg, device="cuda", seed=0,
                                    use_culled_intersect=False),
        "sphere culled": Simulator(sphere, cfg, device="cuda", seed=0, intersect_mode="culled"),
        "ircad_hd culled": Simulator(ircad, cfg, device="cuda", seed=0, intersect_mode="culled"),
        "sphere staged": Simulator(sphere, cfg, device="cuda", seed=0, intersect_mode="staged"),
        "ircad_hd staged": Simulator(ircad, cfg, device="cuda", seed=0, intersect_mode="staged"),
    }
    for mode in ("grouped", "listed"):
        t0 = time.perf_counter()
        sims[f"mega {mode}"] = Simulator(mega, cfg, device="cuda", seed=0, intersect_mode=mode)
        print(f"  mega {mode}: {sims[f'mega {mode}'].culled_tris[0].n_clusters} clusters packed "
              f"and uploaded in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sims["mega bvh"] = Simulator(mega, cfg, device="cuda", seed=0, use_bvh=True)
    sims["mega brute"] = Simulator(mega, cfg, device="cuda", seed=0, use_culled_intersect=False)
    for name in ("sphere bvh", "ircad_hd bvh", "mega bvh"):
        print(f"  {name}: {sims[name].bvh.nodes4.shape[0]} 4-wide nodes (the flat tree's "
              f"{len(sims[name].bvh.flat.meta)}), depth {sims[name].bvh.depth}, stack need "
              f"{sims[name].bvh.stack_need}" + (f"; mega's collapsed and uploaded in "
                                                f"{time.perf_counter() - t0:.1f} s"
                                                if name == "mega bvh" else ""))
    expected = {
        "sphere": {"intersect_listed": cfg.max_depth, **loop},
        "sphere brute": {"intersect": cfg.max_depth, **loop},
        "sphere bvh": {"bvh_intersect": cfg.max_depth, **loop},
        "ircad_hd": {"intersect_listed": cfg.max_depth, **loop},
        "sphere culled": {"intersect_culled": cfg.max_depth, **loop},
        "ircad_hd culled": {"intersect_culled": cfg.max_depth, **loop},
        "sphere staged": {"intersect_staged": cfg.max_depth, **loop},
        "ircad_hd staged": {"intersect_staged": cfg.max_depth, **loop},
        "mega grouped": {"intersect_grouped": cfg.max_depth, "intersect_listed": cfg.max_depth,
                         **loop},
        "mega listed": {"intersect_listed": cfg.max_depth, **loop},
        "ircad_hd bvh": {"bvh_intersect": cfg.max_depth, **loop},
        "ircad_hd brute": {"intersect": cfg.max_depth, **loop},
        "mega bvh": {"bvh_intersect": cfg.max_depth, **loop},
        "mega brute": {"intersect": cfg.max_depth, **loop},
    }
    outs, counts = {}, {}
    for name, sim in sims.items():
        outs[name], counts[name] = drive(name, sim, expected[name])
    compare_mega_frames(outs["mega grouped"], outs["mega listed"])

    # a few requests on the sphere's default set: three poses x two seeds, a compound of four
    sim = sims["sphere"]
    kernels.reset_launch_counts()
    pos0, ang0 = sim.position.cpu(), sim.angles.cpu()
    poses = [(pos0, ang0), (pos0 + torch.tensor([0.3, 0.0, 0.0]), ang0),
             (pos0, ang0 + torch.tensor([0.0, 0.0, 4.0]))]
    for i, (pos, ang) in enumerate(poses):
        for seed in (11, 12):
            b = sim.render_frame(seed, position=pos, angles=ang)["bmode"]
            if not bool(torch.isfinite(b).all()) or not float(b.std()) > 0:
                raise AssertionError(f"request pose {i} seed {seed}: bad frame")
    compound = sim.render_compound([21, 22, 23, 24])
    torch.cuda.synchronize()
    if tuple(compound.shape) != (cfg.bmode_rows, cfg.bmode_cols) or not bool(
            torch.isfinite(compound).all()):
        raise AssertionError("bad compound frame")
    served = kernels.launch_counts()
    frames = len(poses) * 2 + 1  # the compound's four frames are one batched pass
    want = {k: 0 for k in served} | {"intersect_listed": cfg.max_depth * frames, "march": frames,
                                     "postproc": frames, "scanconv": frames}
    print(f"[requests] sphere: {len(poses) * 2} frames + compound of 4 (one batch): launches "
          f"{served}")
    if served != want:
        raise AssertionError(f"request launch counts {served} != {want}")

    # the fit path: target, FIT_STEPS steps, counts set to 0 just before them
    mark("frames and requests")
    fit = fit_phase(sphere, smi)
    mark("fit")
    shard = shard_phase(sphere, sims["sphere"], fit, smi)
    mark("shard")
    batch = batch_phase(sphere, sims["sphere"], fit, smi)
    batch["mega"] = mega_batch_phase(sims["mega listed"])
    bvh_batch = bvh_batch_phase(sims["sphere bvh"])
    batch["launches"]["render_batch_8_bvh"] = bvh_batch["launches"]
    mark("batch")
    chained = chained_phase(sims, smi)
    mark("chained")
    # the probe-pose paths: registration (fd, ad), serve, sweep
    pose_fd_phase(sphere, smi)
    mark("pose fd")
    pose_ad_phase(sphere, smi)
    mark("pose ad")
    with tempfile.TemporaryDirectory() as tmp:
        serve_phase(sims["sphere"], tmp)
        sweep_phase(cfg, tmp)
        render_flags_phase(tmp)
    mark("serve, sweep, render flags")

    # 3. every kernel against its plain version at its path's own inputs
    print("[kernels vs plain]")
    brute_rays = outs["sphere brute"]["segments"]["rays"]
    tri_soa = {"sphere": sims["sphere brute"].scene["tri_soa"],
               "ircad_hd": sims["ircad_hd"].scene["tri_soa"],
               "mega": sims["mega listed"].scene["tri_soa"]}
    differing, t_err = 0, 0.0
    for d in range(cfg.max_depth):
        q = brute_rays[d].contiguous()
        t_k, i_k = intersect.intersect_best(q, tri_soa["sphere"])
        t_p, i_p = intersect.intersect_best_plain(q, tri_soa["sphere"])
        differing += int(((t_k < 1.5) != (t_p < 1.5)).sum() + (i_k != i_p).sum())
        t_err = max(t_err, float((t_k - t_p).abs().max()))
    print(f"  intersect (sphere brute): {differing} differing rays over {cfg.max_depth} bounces, "
          f"max |t| err {t_err:.3e}")
    if differing or t_err:
        raise AssertionError("intersect kernel != plain")
    errs = {"intersect": t_err}
    k1_sample = check_k1_sample(
        [outs["ircad_hd"]["segments"]["rays"][d].contiguous() for d in range(cfg.max_depth)],
        tri_soa["ircad_hd"])
    k1_edges = check_k1_edges()
    bvh_walks, bvh_four_wide = check_bvh(sims, outs, tri_soa, bvh_batch["rays"])
    errs["bvh_intersect"] = 0.0
    cluster_calls = {}
    for name in ("sphere", "ircad_hd", "sphere culled", "ircad_hd culled", "sphere staged",
                 "ircad_hd staged", "mega listed", "mega grouped"):
        scene = name.split()[0]
        cluster_calls[name] = check_cluster_bounces(
            name, sims[name], outs[name]["segments"]["rays"], tri_soa[scene])
        errs[CLUSTER_KERNEL[sims[name].culled_tris[1]]] = 0.0
    mega_sets = bounce_sets(outs["mega listed"]["segments"]["rays"])
    for d in (0, MEGA_LATE_BOUNCE):
        check_listed_shapes(f"mega bounce {d}", [mega_sets[d]], sims["mega listed"].culled_tris[0],
                            tri_soa["mega"])
    # other packet sizes, at every bounce of the sphere and ircad_hd frames
    for scene in ("sphere", "ircad_hd"):
        check_listed_shapes(f"{scene}, every bounce", bounce_sets(outs[scene]["segments"]["rays"]),
                            sims[scene].culled_tris[0], tri_soa[scene], LISTED_TILE_RS)
        for mode in ("culled", "staged"):
            name = f"{scene} {mode}"
            check_cluster_shapes(name, sims[name], outs[name]["segments"]["rays"], tri_soa[scene])
    out, maps = outs["sphere"], sim.scan_maps
    soa, rf_raw, rf_env = out["soa"], out["rf_raw"], out["rf_env"]
    errs["march"] = check_close("march", march.march_cuda(soa, sim.seeds, cfg, cfg.rf_cols),
                                march.march_plain(soa, sim.seeds, cfg, cfg.rf_cols))
    errs["postproc"] = check_close("postproc", postproc.postproc_cuda(rf_raw, cfg),
                                   postproc.postproc_plain(rf_raw, cfg))
    for label, image in made_up_images():
        image = image.cuda()
        print(f"  postproc on a made-up image, {label} {tuple(image.shape)}:")
        check_close("postproc", postproc.postproc_forward(image, cfg),
                    postproc.postproc_plain(image, cfg))
    k4 = scanconv.scan_convert_cuda(rf_env, maps)
    k4_plain = scanconv.scan_convert_coords_plain(rf_env, maps.coords)
    errs["scanconv"] = float((k4 - k4_plain).abs().max())
    k4_table = scanconv.scan_convert_plain(rf_env, maps.table, cfg.bmode_cols)
    print(f"  scanconv: {int((k4 != k4_plain).sum())} differing pixels vs plain (from the maps), "
          f"{int((k4 != k4_table).sum())} vs the table-driven plain version")
    if not (torch.equal(k4, k4_plain) and torch.equal(k4, k4_table)):
        raise AssertionError("scanconv kernel != plain")
    check_close("scanconv", k4, imaging.scan_convert(rf_env, maps.coords[0], maps.coords[1]))
    # the fit path's kernels on the fit frame's SoA and seeded cotangents
    fit_sim, fit_cfg = fit["sim"], fit["cfg"]
    fit_soa = fit["frame"]["soa"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    g_rf = torch.randn((cfg.rf_rows, cfg.rf_cols), device="cuda", generator=gen)
    g_bm = torch.randn((cfg.bmode_rows, cfg.bmode_cols), device="cuda", generator=gen)
    errs["march soft+trilinear"] = check_close(
        "march soft+trilinear", march.march_forward(fit_soa, fit_sim.seeds, fit_cfg, cfg.rf_cols),
        march.march_plain(fit_soa, fit_sim.seeds, fit_cfg, cfg.rf_cols))
    errs["march_bwd"] = check_march_bwd(
        march.march_backward(fit_soa, fit_sim.seeds, g_rf, fit_cfg),
        march.march_bwd_plain(fit_soa, fit_sim.seeds, g_rf, fit_cfg))
    errs["scanconv_bwd"] = check_scanconv_bwd(g_bm, maps, cfg)
    # K2 and K8 at full size: the sphere frame and the fit's set-up, with
    # bitsum normals (K2 bitwise) and with Box–Muller normals
    print("[march at full size] K2 bitwise with bitsum normals")
    full_march = {"frame": compare_march("sphere frame", soa, sim.seeds, cfg, g_rf),
                  "fit set-up": compare_march("fit set-up", fit_soa, fit_sim.seeds, fit_cfg, g_rf)}
    bm = {}
    for label, bm_cfg in (("frame", SimConfig(scatter_rng="boxmuller")),
                          ("fit set-up", SimConfig(scatter_rng="boxmuller", soft_scattering=True,
                                                   trilinear_texture=True))):
        bm_sim = Simulator(sphere, bm_cfg, device="cuda", seed=0)
        kernels.reset_launch_counts()
        bm_out = bm_sim.render_frame(seed=0)
        torch.cuda.synchronize()
        if kernels.launch_counts()["march"] != 1:
            raise AssertionError("the Box–Muller frame did not launch K2")
        check_bmode(f"Box–Muller {label}", bm_sim, bm_out["bmode"])
        bm[label] = (bm_out["soa"], bm_sim.seeds, bm_cfg)
        full_march[f"boxmuller {label}"] = compare_march(f"Box–Muller {label}", *bm[label], g_rf)
    mark("kernels vs plain")
    march_modes = march_modes_phase(sphere)
    tall = check_tall_images(cfg)

    mark("march modes, tall images")
    # 4. the whole CUDA path against the whole plain CPU path, same randomness
    small = small_test_config()
    gpu_sim = Simulator(sphere, small, device="cuda", seed=5)
    cpu_sim = Simulator(sphere, small, device="cpu", seed=5)
    draws = cpu_sim.draws(5)
    on_gpu = simulator.render(
        {k: v.cuda() for k, v in draws.items()}, gpu_sim.seeds, gpu_sim.materials,
        gpu_sim.position, gpu_sim.angles, gpu_sim.scene, gpu_sim.spacing,
        gpu_sim.starting_material, gpu_sim.scan_maps, small, **gpu_sim.trace_kw)
    on_cpu = simulator.render(
        draws, cpu_sim.seeds, cpu_sim.materials, cpu_sim.position, cpu_sim.angles, cpu_sim.scene,
        cpu_sim.spacing, cpu_sim.starting_material, cpu_sim.scan_maps, small, **cpu_sim.trace_kw)
    valid_equal = torch.equal(on_gpu["segments"]["valid"].cpu(), on_cpu["segments"]["valid"])
    rf_err = float((on_gpu["rf_raw"].cpu() - on_cpu["rf_raw"]).abs().max())
    bm_err = float((on_gpu["bmode"].cpu() - on_cpu["bmode"]).abs().max())
    print(f"[cuda path vs cpu path] small config, listed: segments valid equal {valid_equal}, "
          f"rf_raw max err {rf_err:.3e}, bmode max err {bm_err:.3e}")
    if not (valid_equal
            and torch.allclose(on_gpu["rf_raw"].cpu(), on_cpu["rf_raw"], rtol=1e-4, atol=1e-5)
            and torch.allclose(on_gpu["bmode"].cpu(), on_cpu["bmode"], rtol=1e-4, atol=1e-5)):
        raise AssertionError("the CUDA path disagrees with the plain CPU path")
    fit_cuda_vs_cpu(sphere)
    mark("cuda vs cpu: frame, fit")
    pose_fd_cuda_vs_cpu(sphere)
    pose_ad_cuda_vs_cpu(sphere)
    mark("cuda vs cpu: pose")
    plain_modes_phase(sphere)
    drawn = rng_phase(sims["sphere"], smi)
    queries, stress_sets = isotropic_phase(smi)
    mark("plain modes, rng, isotropic")

    # 5. timing (CUDA events, after the warm-up above)
    print(f"[timing] {smi}")
    frame_ms = {name: time_frames(name, sims[name], n) for name, n in TIMED_FRAMES.items()}
    views = {name: device_view(f"{name} frame", lambda sim=sims[name]: sim.render_frame(seed=7),
                               frame_ms[name], expect={"bvh4": cfg.max_depth}
                               if sims[name].bvh is not None else None)
             for name in PROFILED_FRAMES}
    for name, view in views.items():
        if sims[name].culled_tris is None:  # K11's (bvh4_*_kernel) or K1's kernel
            names = {"bvh4" if sims[name].bvh is not None else "intersect_closest"}
        else:  # grouped mode also runs a residual K5 pass
            mode = sims[name].culled_tris[1]
            names = {CLUSTER_KERNEL[mode], CLUSTER_KERNEL["listed" if mode == "grouped" else mode]}
        ours = {k: sum(v for n, v in view["by_name"].items() if k in n) for k in names}
        print(f"  {name} frame, per frame on the device: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(ours.items()))
              + f" of {view['busy_ms']:.3f} ms busy; the frame's draws are "
              f"{drawn['draws_operations']:.0f} of its {view['operations']:.0f} device operations")

    timed = {"sphere": {}, "ircad_hd": {}}
    k1_device_ms = {}
    for scene in ("sphere", "ircad_hd"):
        src = brute_rays if scene == "sphere" else outs["ircad_hd"]["segments"]["rays"]
        bounce_rays = [src[d].contiguous() for d in range(cfg.max_depth)]
        k1_device_ms[scene] = graph_ms(
            lambda q=bounce_rays, s=tri_soa[scene]: [intersect.intersect_best(r, s) for r in q],
            cfg.max_depth)
        soa_t = tri_soa[scene]
        # K1's plain version at 123k triangles is not timed: its (rays x
        # triangles) chunks are the wrong algorithm at that size
        plain_k1 = (lambda q=bounce_rays, s=soa_t: [intersect.intersect_best_plain(r, s) for r in q])
        timed[scene]["intersect"] = (
            lambda q=bounce_rays, s=soa_t: [intersect.intersect_best(r, s) for r in q],
            plain_k1 if scene == "sphere" else None)
        for name in (scene, f"{scene} culled", f"{scene} staged"):
            calls = cluster_calls[name]
            timed[scene][CLUSTER_KERNEL[sims[name].culled_tris[1]]] = (
                lambda c=calls: [k(*a) for k, _, a in c], lambda c=calls: [p(*a) for _, p, a in c])
    mark("frame timing and profiles")
    # the kernels' own wrappers (*_forward, *_backward), without the autograd
    # Function around them: its host time would swamp a 10-microsecond kernel
    timed["sphere"].update({
        "march": (lambda: march.march_forward(soa, sim.seeds, cfg, cfg.rf_cols),
                  lambda: march.march_plain(soa, sim.seeds, cfg, cfg.rf_cols)),
        "postproc": (lambda: postproc.postproc_forward(rf_raw, cfg),
                     lambda: postproc.postproc_plain(rf_raw, cfg)),
        "scanconv": (lambda: scanconv.scan_convert_forward(rf_env, maps),
                     lambda: scanconv.scan_convert_coords_plain(rf_env, maps.coords)),
        "march soft+trilinear": (
            lambda: march.march_forward(fit_soa, fit_sim.seeds, fit_cfg, cfg.rf_cols),
            lambda: march.march_plain(fit_soa, fit_sim.seeds, fit_cfg, cfg.rf_cols)),
        "march_bwd": (lambda: march.march_backward(fit_soa, fit_sim.seeds, g_rf, fit_cfg),
                      lambda: march.march_bwd_plain(fit_soa, fit_sim.seeds, g_rf, fit_cfg)),
        "scanconv_bwd": (
            lambda: scanconv.scan_convert_backward(g_bm, maps),
            lambda: scanconv.scan_convert_bwd_plain(g_bm, maps.table, cfg.rf_rows, cfg.rf_cols)),
    })
    bvh_sets = {name: (sims["sphere bvh" if name == "batch" else f"{name} bvh"].bvh,
                       [r for r, *_ in walks]) for name, walks in bvh_walks.items()}
    for scene in ("sphere", "ircad_hd"):
        dbvh, rays = bvh_sets[scene]
        timed[scene]["bvh_intersect"] = (
            lambda b=dbvh, q=rays: [bvh_intersect.bvh_best(r, b) for r in q],
            lambda b=dbvh, q=rays: [bvh.bvh4_best_plain(r, b) for r in q])
    # seconds per call: timed once
    slow_plain = ("march soft+trilinear", "march_bwd", "bvh_intersect")
    per_call = {k: cfg.max_depth for k in CLUSTER_KERNEL.values()} | {
        "intersect": cfg.max_depth, "bvh_intersect": cfg.max_depth}
    ms = {"sphere": {}, "ircad_hd": {}}
    for scene, fns in timed.items():
        for name, (kernel_fn, plain_fn) in fns.items():
            n = per_call.get(name, 1)
            if plain_fn is None:
                ms[scene][name] = (cuda_ms(kernel_fn, 3) / n, None)
            else:
                ms[scene][name] = paired_ms(
                    kernel_fn, plain_fn, n,
                    p_reps=1 if scene == "ircad_hd" or name in slow_plain else 3)
            k_ms, p_ms = ms[scene][name]
            plain = f"plain {p_ms:.4f} ms ({p_ms / k_ms:.1f}x)" if p_ms else "plain not timed"
            print(f"  {scene} {name}: kernel {k_ms:.4f} ms, {plain} per launch")

    # K10 on its main path, the mega grouped frame: all bounces, then bounce 0
    # (the coherent fan) and a late bounce beside K5 on the same rays
    mega_sim, mega_calls = sims["mega grouped"], cluster_calls["mega grouped"]
    main_ms = dict(ms["sphere"])
    main_ms["intersect_grouped"] = paired_ms(
        lambda: [k(*a) for k, _, a in mega_calls], lambda: [p(*a) for _, p, a in mega_calls],
        cfg.max_depth, k_reps=5, p_reps=1)
    print(f"  mega grouped intersect_grouped: kernel {main_ms['intersect_grouped'][0]:.4f} ms, plain "
          f"{main_ms['intersect_grouped'][1]:.4f} ms per launch (mean over {cfg.max_depth} bounces)")
    mega_rays = outs["mega grouped"]["segments"]["rays"]
    mega_queries = {
        d: time_grouped_query(f"mega bounce {d}", mega_rays[d][0:3].T.contiguous(),
                              mega_rays[d][3:6].T.contiguous(), mega_sim.culled_tris[0],
                              mega_sim.intersect_tile_r)
        for d in (0, MEGA_LATE_BOUNCE)}
    # K10's device time per launch replayed from a graph: the frame's ten
    # bounces, the two bounces and the two 200k sets; the grid of bounce 0's launch
    k10_device_ms = {"mega": graph_ms(lambda: [k(*a) for k, _, a in mega_calls], cfg.max_depth),
                     **{f"mega_bounce_{d}": q["k10_device_ms"] for d, q in mega_queries.items()},
                     **{f"stress_200k_{n}": q["k10_device_ms"] for n, q in queries.items()}}
    intersect_grouped.grouped_winners(*mega_calls[0][2])
    k10_blocks = intersect_grouped.last_blocks
    print("  device ms per launch (graph replay): intersect_grouped "
          + ", ".join(f"{name} {v:.5f}" for name, v in k10_device_ms.items())
          + f"; {k10_blocks} blocks (mega)")

    # K5 where it is the device's largest item: the mega listed frame's ten
    # launches, then both redesigned kernels' device time replayed from a graph
    mega_listed_calls = cluster_calls["mega listed"]
    k5_mega_ms = cuda_ms(lambda: [k(*a) for k, _, a in mega_listed_calls], 5) / cfg.max_depth
    print(f"  mega listed intersect_listed: kernel {k5_mega_ms:.4f} ms per launch (mean over "
          f"{cfg.max_depth} bounces); bounce 0 {mega_queries[0]['k5_ms']:.4f}, bounce "
          f"{MEGA_LATE_BOUNCE} {mega_queries[MEGA_LATE_BOUNCE]['k5_ms']:.4f}; 200k fan "
          f"{queries['fan']['k5_ms']:.4f}, isotropic {queries['isotropic']['k5_ms']:.4f}")
    k5_sets = {
        "sphere": [a for _, _, a in cluster_calls["sphere"]],
        "ircad_hd": [a for _, _, a in cluster_calls["ircad_hd"]],
        "mega": [a for _, _, a in mega_listed_calls],
        "mega_late_bounce": [mega_listed_calls[MEGA_LATE_BOUNCE][2]],
        "stress_200k_fan": [stress_sets["fan"]],
        "stress_200k_isotropic": [stress_sets["isotropic"]]}
    k5_device_ms = {
        name: graph_ms(lambda: [intersect_listed.listed_best(*a) for a in calls], len(calls))
        for name, calls in k5_sets.items()}
    k3_device_ms = graph_ms(lambda: postproc.postproc_forward(rf_raw, cfg), 1)
    print("  device ms per launch (graph replay): intersect_listed "
          + ", ".join(f"{name} {v:.4f}" for name, v in k5_device_ms.items())
          + f"; postproc {k3_device_ms:.4f}")
    # K6 and K7 on their frames' ten bounces, both scenes; the grid of a sphere launch
    cluster_device_ms = {
        CLUSTER_KERNEL[mode]: {
            scene: graph_ms(lambda c=cluster_calls[f"{scene} {mode}"]: [k(*a) for k, _, a in c],
                            cfg.max_depth)
            for scene in ("sphere", "ircad_hd")}
        for mode in ("culled", "staged")}
    cluster_blocks = {}
    for mode in ("culled", "staged"):
        kernel, _, args = cluster_calls[f"sphere {mode}"][0]
        kernel(*args)
        cluster_blocks[CLUSTER_KERNEL[mode]] = getattr(kernels, CLUSTER_KERNEL[mode]).last_blocks
    print("  device ms per launch (graph replay): " + "; ".join(
        f"{name} " + ", ".join(f"{scene} {v:.4f}" for scene, v in by_scene.items())
        for name, by_scene in cluster_device_ms.items())
          + f"; blocks {cluster_blocks}")
    # K2 and K8, default and Box–Muller, replayed from a graph; their grids
    k2_device_ms = {
        "frame": graph_ms(lambda: march.march_forward(soa, sim.seeds, cfg, cfg.rf_cols), 1),
        "fit_mode": graph_ms(lambda: march.march_forward(fit_soa, fit_sim.seeds, fit_cfg,
                                                         cfg.rf_cols), 1),
        "boxmuller_frame": graph_ms(lambda: march.march_forward(*bm["frame"], cfg.rf_cols), 1),
        "boxmuller_fit_mode": graph_ms(lambda: march.march_forward(*bm["fit set-up"],
                                                                   cfg.rf_cols), 1)}
    k8_device_ms = {
        "fit_mode": graph_ms(lambda: march.march_backward(fit_soa, fit_sim.seeds, g_rf, fit_cfg), 1),
        "boxmuller_fit_mode": graph_ms(lambda: march.march_backward(*bm["fit set-up"][:2], g_rf,
                                                                    bm["fit set-up"][2]), 1)}
    march.march_forward(soa, sim.seeds, cfg, cfg.rf_cols)
    march.march_backward(fit_soa, fit_sim.seeds, g_rf, fit_cfg)
    k2_blocks, k8_blocks = march.last_blocks, march.last_blocks_bwd
    print("  device ms per launch (graph replay): march " + ", ".join(
        f"{k} {v:.4f}" for k, v in k2_device_ms.items()) + "; march_bwd " + ", ".join(
        f"{k} {v:.4f}" for k, v in k8_device_ms.items())
          + f"; blocks march {k2_blocks}, march_bwd {k8_blocks}")
    print(f"  device ms per launch (graph replay): intersect sphere brute "
          f"{k1_device_ms['sphere']:.5f}, ircad_hd {k1_device_ms['ircad_hd']:.5f}")
    # K11 on every bvh ray set; the bound from the reference walk's counts,
    # and both walks' nodes and triangles per live ray
    k11 = {"device_ms": {}, "blocks": {}, "bound": {}, "walks": {}, "touched": {}}
    for name, (dbvh, rays) in bvh_sets.items():
        k11["device_ms"][name] = graph_ms(
            lambda b=dbvh, q=rays: [bvh_intersect.bvh_best(r, b) for r in q], cfg.max_depth)
        k11["blocks"][name] = bvh_intersect.last_blocks
        k11["bound"][name] = roofline.bvh_bound(bvh_walks[name], dbvh)
        k11["walks"][name] = walk_means(bvh_walks[name], bvh_four_wide[name])
        k11["touched"][name] = roofline.bvh_touched(bvh_walks[name])
        (b_ms, b_by), walks = k11["bound"][name], k11["walks"][name]
        print(f"  device ms per launch (graph replay): bvh_intersect {name} "
              f"{k11['device_ms'][name]:.5f} ({k11['blocks'][name]} blocks), bound {b_ms:.5f} ms "
              f"by {b_by} ({b_ms / k11['device_ms'][name]:.2%} of it; a launch touches "
              f"{k11['touched'][name]['nodes']:.1f} flat nodes and "
              f"{k11['touched'][name]['triangles']:.1f} triangles); per live ray (of "
              f"{walks['live_rays']}) the binary walk pops {walks['binary_pops']:.2f} nodes and "
              f"tests {walks['binary_tests']:.2f} triangles, the 4-wide walk visits "
              f"{walks['four_wide_nodes']:.2f} and tests {walks['four_wide_tests']:.2f}")
    k11_device_ms, k11_blocks = k11["device_ms"], k11["blocks"]
    print(f"  intersect_listed sphere {k5_device_ms['sphere']:.5f} ms device, beside K11's "
          f"{k11_device_ms['sphere']:.5f}")
    batch_rays = bvh_sets["batch"][1]
    k11_batch = {"ms": cuda_ms(lambda: [bvh_intersect.bvh_best(r, bvh_sets["batch"][0])
                                        for r in batch_rays], 5) / cfg.max_depth,
                 "device_ms": k11_device_ms["batch"], "bound_ms": k11["bound"]["batch"][0],
                 "bound_by": k11["bound"]["batch"][1], "blocks": k11_blocks["batch"],
                 "frames": len(BATCH_SEEDS)}
    # the grid of one sphere launch of each, as the launch reported it
    intersect_listed.listed_best(*cluster_calls["sphere"][0][2])
    postproc.postproc_forward(rf_raw, cfg)
    intersect.intersect_best(brute_rays[0].contiguous(), tri_soa["sphere"])
    scanconv.scan_convert_forward(rf_env, maps)
    scanconv.scan_convert_backward(g_bm, maps)
    k5_blocks, k3_blocks = intersect_listed.last_blocks, postproc.last_blocks
    k1_blocks, k4_blocks = intersect.last_blocks, scanconv.last_blocks
    k9_blocks = scanconv.last_blocks_bwd
    print(f"  blocks per launch on the sphere frame: intersect_listed {k5_blocks}, postproc "
          f"{k3_blocks}, intersect (brute) {k1_blocks}, scanconv {k4_blocks}, scanconv_bwd "
          f"{k9_blocks}; intersect_grouped (mega bounce 0) {k10_blocks} (132 SMs)")
    if min(k5_blocks, k1_blocks, k4_blocks, k9_blocks, k10_blocks, k11_blocks["sphere"],
           *cluster_blocks.values()) < 66 or k3_blocks < 64:
        raise AssertionError("a redesigned kernel launches too few blocks to fill half the card")
    # the floor small kernels are read against: the cheapest call of the library, back to back
    one_ray, one_tri = brute_rays[0][:, :1].contiguous(), tri_soa["sphere"][:, :1].contiguous()
    empty_launch_ms = cuda_ms(lambda: intersect.intersect_best(one_ray, one_tri), 100)
    print(f"  empty_launch_ms {empty_launch_ms:.5f} (K1 on one ray and one triangle: one launch of "
          f"one block, a cluster of one; mean of 100 launches back to back, its two output "
          f"allocations included)")

    # the one PyTorch call that computes the same function, where there is one
    grid_sample = grid_sample_remap(maps.coords[0], maps.coords[1], cfg.rf_rows, cfg.rf_cols)
    transposed = torch.sparse_csr_tensor(
        maps.row_ptr, maps.pixel, maps.weight,
        size=(cfg.rf_rows * cfg.rf_cols, cfg.bmode_rows * cfg.bmode_cols))
    library_ms = {
        "scanconv": cuda_ms(lambda: grid_sample(rf_env), 20),
        "scanconv_bwd": cuda_ms(lambda: torch.mv(transposed, g_bm.reshape(-1)), 20),
    }
    gs_err = float((grid_sample(rf_env) - scanconv.scan_convert_forward(
        rf_env, maps)).abs().max())
    mv_err = float((torch.mv(transposed, g_bm.reshape(-1)).reshape(cfg.rf_rows, cfg.rf_cols)
                    - scanconv.scan_convert_backward(g_bm, maps)).abs().max())
    print(f"  library calls: grid_sample {library_ms['scanconv']:.4f} ms (max |diff| to K4 "
          f"{gs_err:.3e}), sparse CSR mv {library_ms['scanconv_bwd']:.4f} ms (max |diff| to K9 "
          f"{mv_err:.3e}); no single PyTorch call computes K1-K3, K5-K8, K10")
    # K4 and K9 beside their library calls without the host's time per launch
    scan_device_ms = {
        "scanconv": (graph_ms(lambda: scanconv.scan_convert_forward(rf_env, maps), 1),
                     graph_ms(lambda: grid_sample(rf_env), 1)),
        "scanconv_bwd": (graph_ms(lambda: scanconv.scan_convert_backward(g_bm, maps), 1),
                         graph_ms(lambda: torch.mv(transposed, g_bm.reshape(-1)), 1))}
    print("  device ms per launch (graph replay), kernel / library: " + "; ".join(
        f"{name} {k:.4f} / {lib:.4f}" for name, (k, lib) in scan_device_ms.items()))

    mark("kernel timing")
    # the least time the card could take for each kernel's work on this run's inputs
    n_bm = cfg.bmode_rows * cfg.bmode_cols
    steps_frame, steps_fit = (roofline.matched_steps(soa, cfg, cfg.rf_cols),
                              roofline.matched_steps(fit_soa, fit_cfg, cfg.rf_cols))
    ircad_rays = outs["ircad_hd"]["segments"]["rays"]
    ircad_bounds = {
        "intersect": roofline.brute_bound(
            [ircad_rays[d].contiguous() for d in range(cfg.max_depth)], tri_soa["ircad_hd"]),
        **{CLUSTER_KERNEL[sims[name].culled_tris[1]]: cluster_bound(sims[name], cluster_calls[name])
           for name in ("ircad_hd", "ircad_hd culled", "ircad_hd staged")},
        "bvh_intersect": k11["bound"]["ircad_hd"]}
    bounds = {
        "intersect": roofline.brute_bound(
            [brute_rays[d].contiguous() for d in range(cfg.max_depth)], tri_soa["sphere"]),
        "intersect_listed": cluster_bound(sims["sphere"], cluster_calls["sphere"]),
        "intersect_culled": cluster_bound(sims["sphere culled"], cluster_calls["sphere culled"]),
        "intersect_staged": cluster_bound(sims["sphere staged"], cluster_calls["sphere staged"]),
        "intersect_grouped": roofline.grouped_bound([a for _, _, a in mega_calls]),
        "march": roofline.march_cost(soa, cfg, cfg.rf_cols).floor(),
        "march soft+trilinear": roofline.march_cost(fit_soa, fit_cfg, cfg.rf_cols).floor(),
        "march_bwd": roofline.march_bwd_cost(fit_soa, fit_cfg, cfg.rf_cols).floor(),
        "postproc": roofline.postproc_cost(cfg).floor(),
        "scanconv": roofline.scanconv_cost(cfg).floor(),
        "scanconv_bwd": roofline.scanconv_bwd_cost(cfg, maps.pixel.numel()).floor(),
        "bvh_intersect": k11["bound"]["sphere"],
    }
    print(f"  march steps inside the window: frame {steps_frame}, fit frame {steps_fit}; "
          f"transposed remap taps {maps.pixel.numel()}; bytes the scan kernels read beyond their "
          f"bound's: K4's maps {roofline.nbytes(maps.coords) - 2 * 4 * n_bm}, K9's CSR lists "
          f"{roofline.nbytes(maps.row_ptr, maps.pixel, maps.weight) - 2 * 4 * n_bm}")
    roofline_phase(sims, outs, bvh_walks, smi)
    mark("roofline")

    path_of = {"intersect": "sphere brute", "intersect_listed": "sphere",
               "intersect_culled": "sphere culled", "intersect_staged": "sphere staged",
               "intersect_grouped": "mega grouped", "march": "sphere", "postproc": "sphere",
               "scanconv": "sphere", "bvh_intersect": "sphere bvh"}
    record = []
    for name, (src, replaces) in SOURCES.items():
        k_ms, p_ms = main_ms[name]
        # per run of the kernel's main path: one frame, or one fit step for K8
        # and K9 (the fit run's count over the steps it ran, checked whole above)
        fit_launches = fit["counts"][name] // fit["steps"]
        launches = counts[path_of[name]][name] if name in path_of else fit_launches
        entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": launches, "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
                 "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                 "library_ms": library_ms.get(name),
                 "fit_step_launches": fit_launches}
        if name in ms["ircad_hd"]:
            entry["ircad_hd_ms"], entry["ircad_hd_plain_ms"] = ms["ircad_hd"][name]
        if name in ircad_bounds:
            entry["ircad_hd_bound_ms"], entry["ircad_hd_bound_by"] = ircad_bounds[name]
        if name in ("intersect_listed", "postproc"):
            entry["empty_launch_ms"] = empty_launch_ms
            entry["device_ms"] = k5_device_ms if name == "intersect_listed" else k3_device_ms
        if name in cluster_device_ms:  # by scene
            entry.update({"device_ms": cluster_device_ms[name], "blocks": cluster_blocks[name],
                          "tile_rs_checked": list(CLUSTER_TILE_RS)})
        if name in scan_device_ms:
            entry["device_ms"], entry["library_device_ms"] = scan_device_ms[name]
            entry["also_replaces"] = ALSO_REPLACES[name]
        if name == "scanconv":
            entry["blocks"] = k4_blocks
        if name == "intersect":  # by scene; the ircad_hd sample and the edge shapes
            entry.update({"device_ms": k1_device_ms, "blocks": k1_blocks,
                          "ircad_hd_sample": k1_sample, "edge_shapes": k1_edges})
        if name == "intersect_listed":  # where K5 is the device's largest item, K10's rays
            entry.update({"blocks": k5_blocks, "mega_ms": k5_mega_ms,
                          "mega_late_bounce_ms": mega_queries[MEGA_LATE_BOUNCE]["k5_ms"],
                          "stress_200k_isotropic_ms": queries["isotropic"]["k5_ms"]})
        if name == "postproc":
            entry["blocks"] = k3_blocks
            entry["tall"] = {str(rows): v for rows, v in tall.items()}
        if name == "march":
            entry.update({"device_ms": k2_device_ms["frame"], "blocks": k2_blocks,
                          "fit_mode_device_ms": k2_device_ms["fit_mode"],
                          "boxmuller_device_ms": k2_device_ms["boxmuller_frame"],
                          "boxmuller_fit_mode_device_ms": k2_device_ms["boxmuller_fit_mode"],
                          "full_size": {k: v for k, v in full_march.items()},
                          "field_modes": len(march_modes),
                          "field_mode_flips": {k: v["flips"] for k, v in march_modes.items()
                                               if "boxmuller" in k}})
        if name == "march_bwd":
            entry.update({"device_ms": k8_device_ms["fit_mode"], "blocks": k8_blocks,
                          "boxmuller_device_ms": k8_device_ms["boxmuller_fit_mode"],
                          "worst_field_err": max(v["bwd_worst"] for v in full_march.values())})
        if name == "intersect_grouped":  # bounce by bounce, and the queries it was built for
            entry.update({"device_ms": k10_device_ms, "blocks": k10_blocks,
                          "mega": {f"bounce_{d}": q for d, q in mega_queries.items()},
                          "stress_200k": queries})
        if name == "scanconv_bwd":
            entry["blocks"] = k9_blocks
        if name == "bvh_intersect":
            entry.update({"note": "no TPU kernel: the reference's jnp while_loop traversal",
                          "device_ms": k11_device_ms, "blocks": k11_blocks,
                          "bound_by_set": k11["bound"], "walks": k11["walks"],
                          "touched": k11["touched"],
                          "batch": k11_batch})
        if name == "march":  # the fit runs K2 in soft + trilinear mode: its own numbers
            mode = "march soft+trilinear"
            entry.update({"fit_mode_ms": ms["sphere"][mode][0],
                          "fit_mode_plain_ms": ms["sphere"][mode][1],
                          "fit_mode_bound_ms": bounds[mode][0], "fit_mode_bound_by": bounds[mode][1],
                          "fit_mode_max_abs_err": errs[mode]})
        # launches on the sharded path (one-rank NCCL group): per frame in each
        # imaging mode, and per sharded train step
        entry["sharded_launches"] = {mode: n[name] for mode, n in shard["launches"].items()}
        # launches per batched set-up (one pass of 8 frames, the 28-frame fd
        # step, the 4-frame fit step), and per launch at the batch's shapes
        entry["batch_launches"] = {label: n[name] for label, n in batch["launches"].items()}
        if name in batch["kernels"]:
            entry["batch"] = batch["kernels"][name]
        # launches inside one chained call's graph replays, by the profiler's kernel names
        event = roofline.EVENT_NAMES[name]
        if event in chained["sphere"]["graph"]["launches_by_name"]:
            entry["chained_replay_launches"] = {
                scene: row["graph"]["launches_by_name"][event] for scene, row in chained.items()}
        record.append(entry)
        print(f"  {name}: {k_ms:.4f} ms, bound {bounds[name][0]:.5f} ms by {bounds[name][1]} "
              f"({bounds[name][0] / k_ms:.1%} of the kernel's time; {bounds[name].n_bytes:.1f} "
              f"bytes, {bounds[name].n_ops:.1f} operations)")

    print("[shard] summary: " + json.dumps({k: v for k, v in shard.items() if k != "launches"}))
    print("[batch] summary: " + json.dumps(
        {k: v for k, v in batch.items() if k not in ("launches", "kernels")}, default=str))
    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
