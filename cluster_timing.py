#!/usr/bin/env python3
"""Time the port's closest hits and scan conversion on one NVIDIA GPU, in one short process.

    python3 cluster_timing.py [--tree DIR] [--only k11]

Imports ``mcray_tpu_torch`` from DIR (default: the directory of this
script), so one copy of the script times two checkouts in turns: run it
alternately with ``--tree`` of each, one process per run. The times
and the profile are taken as ``chip_smoke.py`` takes them, by
``mcray_tpu_torch/utils/benchmarking.py`` of this script's checkout. At
``SimConfig()`` widths it renders seed 0 of the sphere and the ircad_hd frames in listed
(K5), culled (K6) and staged (K7) mode and of the mega frame in listed and
grouped (K10) mode, takes each frame's ten bounces of rays, and times the
frame's closest-hit kernel on them replayed from a CUDA graph (the launches
back to back, without the host's time to launch each): device ms per
launch, mean over the bounces. K10 is timed as the function it computes,
each ray's winner over its cluster tables (the tree's kernel and whatever
per-ray reduction follows it there), on every mega grouped bounce, on
bounces 0 and 5 apart, and on the 200,000-triangle fan and isotropic sets
(``scene/stress.py``); the kernel alone by ``torch.profiler``. The same for
the brute closest hit (K1) on the sphere brute frame's bounces and on the
ircad_hd listed frame's, for the scan conversion (K4) on the sphere brute
frame's RF image beside ``grid_sample``, and for its backward (K9) on a
seeded B-mode cotangent, also with the L2 cache flushed before each call
and on a 400 x 500 image over 64 RF columns (up to 30 taps an RF cell). The
sphere (listed and brute), ircad_hd (listed, culled and staged) and mega
(listed, grouped) frames are then timed by CUDA events (5 frames) and
profiled by ``torch.profiler`` (3 frames): device busy ms, the idle share
against the unprofiled median, device operations and the closest-hit
kernel's ms per frame (each profile holds every launch of the kernel it
reads, or is taken again). The K11 section (all that ``--only k11`` runs)
renders seed 0 of the sphere, ircad_hd and mega frames with ``use_bvh`` and
the sphere's 8-seed batch (seeds 0-7, 20,480 rays a bounce), and times the
BVH traversal (K11) on each set's ten bounces replayed from a CUDA graph
(device ms per launch, mean over the bounces), with its blocks and the mean
nodes and triangles per live ray by its own counts, and, summed over the
bounces that have a live ray, each launch beside its slowest ray (the most
nodes) launched alone and that ray's nodes: how much of a launch is one
ray's chain of dependent loads, and its ms per node; then times (5 frames)
and profiles (3) the three bvh frames as above. ``--only k11`` is for the
in-turns A/B of K11 (four runs: parent, change, change, parent), so that
those runs hold the card for that section alone. Prints one JSON line: the tree, the
card's ``nvidia-smi`` name and power limit, and the numbers, with a digest
of each ray set so that two trees' runs can be seen to time the same rays.
Needs the card; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys


def _own_benchmarking():
    """This checkout's ``mcray_tpu_torch/utils/benchmarking.py``, loaded by its
    path: every ``--tree`` is timed by this one copy, and importing the package
    here would bind ``mcray_tpu_torch`` to this checkout instead of the tree's."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mcray_tpu_torch", "utils",
                        "benchmarking.py")
    spec = importlib.util.spec_from_file_location("benchmarking", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_timing = _own_benchmarking()
busy_view, cold_graph_ms, event_ms = _timing.busy_view, _timing.cold_graph_ms, _timing.event_ms
graph_ms, grid_sample_remap, nvidia_smi = (_timing.graph_ms, _timing.grid_sample_remap,
                                           _timing.nvidia_smi)

SCENES = {  # name: (scene file, directory its meshes are generated into)
    "sphere": (("assets", "sphere", "sphere.scene"), None),
    "ircad_hd": (("assets", "ircad11_hd", "santi-liver-hd.scene"),
                 ("build", "mcray_tpu_torch", "ircad11_hd")),
    "mega": (("assets", "ircad11_mega", "santi-liver-mega.scene"),
             ("build", "mcray_tpu_torch", "ircad11_mega")),
}
RUNS = [("sphere", "listed"), ("sphere", "culled"), ("sphere", "staged"), ("ircad_hd", "listed"),
        ("ircad_hd", "culled"), ("ircad_hd", "staged"), ("mega", "listed"), ("mega", "grouped")]
PROFILED = [("sphere", "listed"), ("sphere", "brute"), ("ircad_hd", "listed"), ("ircad_hd", "culled"),
            ("ircad_hd", "staged"), ("mega", "listed"), ("mega", "grouped")]
# the closest-hit kernel of each mode, by its name in the profile
KERNEL_NAME = {"brute": "intersect_closest_kernel", "listed": "intersect_listed_kernel",
               "culled": "intersect_culled_kernel", "staged": "intersect_staged_kernel",
               "grouped": "intersect_grouped_kernel", "bvh": "bvh"}
MEGA_BOUNCES = (0, 5)     # K10 also on these bounces alone
STRESS_TRIS, STRESS_RAYS = 200_000, 2560


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=here, help="checkout whose mcray_tpu_torch is timed")
    parser.add_argument("--only", choices=["all", "k11"], default="all",
                        help="k11: the K11 section alone")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("cluster_timing: torch.cuda.is_available() is false; this needs an NVIDIA GPU")

    import mcray_tpu_torch
    from mcray_tpu_torch.config import SimConfig, small_test_config
    from mcray_tpu_torch.models.simulator import Simulator
    from mcray_tpu_torch.ops import clusters, imaging
    from mcray_tpu_torch.ops.bvh import build_bvh
    from mcray_tpu_torch.ops.cuda import (bvh_intersect, intersect, intersect_culled,
                                          intersect_grouped, intersect_listed, intersect_staged,
                                          last_grid, launch_counts, scanconv)
    from mcray_tpu_torch.ops.geometry import NO_HIT_T
    from mcray_tpu_torch.scene import stress
    from mcray_tpu_torch.scene.compile import load_and_compile

    if not os.path.abspath(mcray_tpu_torch.__file__).startswith(tree + os.sep):
        raise SystemExit(f"cluster_timing: imported {mcray_tpu_torch.__file__}, not from {tree}")
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def grouped_winners(padded, ray_ids, counts, packed):
        """K10's function: each ray's winner over its cluster tables (the
        tree's kernel and, where it writes per-(cluster, slot) tables, the
        per-ray reduction that follows it there)."""
        if hasattr(intersect_grouped, "grouped_winners"):
            return intersect_grouped.grouped_winners(padded, ray_ids, counts, packed)
        return clusters.ray_winners(ray_ids, *intersect_grouped.grouped_best(
            padded, ray_ids, counts, packed), padded.shape[1])

    def grouped_args(o, s, packed, tile_r):
        op, sp, padded = clusters.pad_rays(o, s, tile_r, 1e9)
        hit_m, _ = clusters.ray_cluster_hits(op, sp, packed)
        ray_ids, counts, _ = clusters.cluster_ray_tables(
            hit_m, intersect_grouped.GROUP_G, intersect_grouped.CHUNK_G)
        return padded, ray_ids, counts, packed

    def kernel_calls(sim, rays):
        """(kernel, arguments) of the frame's closest hit at each bounce."""
        packed, mode = sim.culled_tris
        tile_r = sim.intersect_tile_r
        calls = []
        for d in range(rays.shape[0]):
            o, s = rays[d][0:3].T.contiguous(), rays[d][3:6].T.contiguous()
            if mode == "grouped":
                calls.append((grouped_winners, grouped_args(o, s, packed, tile_r)))
                continue
            op, sp, padded = clusters.pad_rays(o, s, tile_r)
            if mode == "listed":
                live = torch.abs(sp).sum(dim=1) > 0.0
                calls.append((intersect_listed.listed_best, (
                    padded, *clusters.packet_cluster_lists(op, sp, packed, tile_r),
                    torch.where(live, NO_HIT_T, 0.0), torch.zeros_like(live, dtype=torch.int32),
                    packed)))
            else:
                best = (intersect_culled.culled_best if mode == "culled"
                        else intersect_staged.staged_best)
                calls.append((best, (padded, packed, tile_r)))
        return calls

    def digest(rays):
        return [float(rays.double().sum()), int((rays[:, 3:6].abs().sum(dim=1) > 0).sum())]

    def brute_ms(rays, tri_soa):
        """K1's device ms per launch on a frame's bounces."""
        bounces = [rays[d].contiguous() for d in range(rays.shape[0])]
        return graph_ms(lambda: [intersect.intersect_best(r, tri_soa) for r in bounces],
                        len(bounces))

    cfg = SimConfig()
    packs, sims, out = {}, {}, {"tree": tree, "gpu": smi, "device_ms": {}, "rays_digest": {}}

    def pack_of(scene):
        if scene not in packs:
            path, assets = SCENES[scene]
            packs[scene] = load_and_compile(os.path.join(tree, *path),
                                            asset_dir=assets and os.path.join(tree, *assets))
        return packs[scene]

    def profile_frames(runs):
        """Each frame timed by events (5) and profiled (3), as ``out["frames"]``."""
        kernel = {"brute": "intersect", "listed": "intersect_listed", "culled": "intersect_culled",
                  "staged": "intersect_staged", "grouped": "intersect_grouped",
                  "bvh": "bvh_intersect"}
        for scene, mode in runs:
            sim = sims[scene, mode]
            seeds = iter(range(100, 105))
            frame_ms = event_ms(lambda: sim.render_frame(seed=next(seeds)), 5)
            before = launch_counts()[kernel[mode]]
            sim.render_frame(seed=7)
            launched = launch_counts()[kernel[mode]] - before
            view = busy_view(lambda: sim.render_frame(seed=7), 3,
                             expect={KERNEL_NAME[mode]: launched})
            med = statistics.median(frame_ms)
            out.setdefault("frames", {})[f"{scene} {mode}"] = {
                "median_ms": med, "min_ms": min(frame_ms), "max_ms": max(frame_ms),
                "busy_ms": view["busy_ms"], "idle_share": 1 - view["busy_ms"] / med,
                "device_operations": view["operations"],
                "kernel_ms": sum(v for k, v in view["by_name"].items() if KERNEL_NAME[mode] in k)}

    # K11 on the bvh frames' bounces and on the sphere's batch of 8; then the
    # bvh frames timed and profiled
    bvh_sets = {}
    for scene in ("sphere", "ircad_hd", "mega"):
        sim = sims[scene, "bvh"] = Simulator(pack_of(scene), cfg, device="cuda", seed=0,
                                             use_bvh=True)
        rays = sim.render_frame(seed=0)["segments"]["rays"]
        bvh_sets[scene] = (sim.bvh, [rays[d].contiguous() for d in range(rays.shape[0])])
        out["rays_digest"][f"{scene} bvh"] = digest(rays)
    batch = sims["sphere", "bvh"].render_frames(list(range(8)))["segments"]["rays"]
    bvh_sets["sphere batch of 8"] = (sims["sphere", "bvh"].bvh,
                                     [batch[d].contiguous() for d in range(batch.shape[0])])
    out["rays_digest"]["sphere batch of 8"] = digest(batch)
    out["k11"] = {}
    for name, (dbvh, bounces) in bvh_sets.items():
        entry = out["k11"][name] = {
            "device_ms": graph_ms(lambda b=dbvh, q=bounces: [bvh_intersect.bvh_best(r, b)
                                                             for r in q], len(bounces)),
            "blocks": last_grid("bvh_intersect")}
        live = tallies = 0
        slowest = {"launches_ms": 0.0, "alone_ms": 0.0, "nodes": 0}
        for r in bounces:
            alive = r[3:6].abs().sum(dim=0) > 0
            counts = bvh_intersect.bvh_best(r, dbvh, counts=True)[2]
            tallies = tallies + counts[:, alive].sum(dim=1).double()
            live += int(alive.sum())
            if not bool(alive.any()):
                continue
            # the launch against its slowest ray (the most nodes) launched alone
            j = int(counts[0].argmax())
            one = r[:, j:j + 1].contiguous()
            slowest["launches_ms"] += graph_ms(lambda q=r: bvh_intersect.bvh_best(q, dbvh), 1)
            slowest["alone_ms"] += graph_ms(lambda q=one: bvh_intersect.bvh_best(q, dbvh), 1)
            slowest["nodes"] += int(counts[0, j])
        entry["nodes_per_live_ray"], entry["tests_per_live_ray"] = (tallies / live).tolist()
        entry["slowest_ray"] = slowest
    profile_frames([(scene, "bvh") for scene in ("sphere", "ircad_hd", "mega")])
    if args.only == "k11":
        print(json.dumps(out))
        return 0

    k10_sets = {}  # K10's argument sets by name
    for scene, mode in RUNS:
        sim = sims[scene, mode] = Simulator(pack_of(scene), cfg, device="cuda", seed=0,
                                            intersect_mode=mode)
        rays = sim.render_frame(seed=0)["segments"]["rays"]
        calls = kernel_calls(sim, rays)
        key = f"{scene} {mode}"
        out["device_ms"][key] = graph_ms(lambda c=calls: [k(*a) for k, a in c], len(calls))
        out["rays_digest"][key] = digest(rays)
        if key == "ircad_hd listed":  # K1 on the same rays
            out["device_ms"]["ircad_hd brute"] = brute_ms(rays, sim.scene["tri_soa"])
        if mode == "grouped":
            k10_sets = {f"mega bounce {d}": [calls[d][1]] for d in MEGA_BOUNCES}
            k10_sets["mega grouped"] = [a for _, a in calls]

    # K10 on the 200k stress scene's coherent fan and isotropic rays, as chip_smoke.py builds them
    tris, mids = stress.build_scene_arrays(STRESS_TRIS)
    fan_o, fan_s, iso_o, iso_s = (torch.from_numpy(a).cuda() for a in stress.make_rays(STRESS_RAYS))
    stress_pack = clusters.pack_tris_culled(tris, mids, build_bvh(tris).tri_order,
                                            sort_origin=fan_o[0].cpu().numpy(), tile_t=128,
                                            device="cuda")
    for name, (o, s) in {"stress 200k fan": (fan_o, fan_s),
                         "stress 200k isotropic": (iso_o, iso_s)}.items():
        k10_sets[name] = [grouped_args(o, s, stress_pack, 512)]
        out["rays_digest"][name] = digest(torch.cat([o, s], dim=1).T[None])
    out["k10"] = {}
    for name, sets in k10_sets.items():
        view = busy_view(lambda c=sets: [grouped_winners(*a) for a in c], 10,
                         expect={KERNEL_NAME["grouped"]: len(sets)})
        out["k10"][name] = {
            "device_ms": graph_ms(lambda c=sets: [grouped_winners(*a) for a in c], len(sets)),
            "kernel_profiler_ms": sum(v for k, v in view["by_name"].items()
                                      if KERNEL_NAME["grouped"] in k) / len(sets),
            "operations": view["operations"] / len(sets),
            "incidences_in_tables": sum(int(a[2].sum()) for a in sets) / len(sets),
            "clusters_with_rays": sum(int((a[2] > 0).sum()) for a in sets) / len(sets)}

    # K1 on the sphere brute frame's bounces; K4 on its RF image beside grid_sample
    sim = sims["sphere", "brute"] = Simulator(packs["sphere"], cfg, device="cuda", seed=0,
                                              use_culled_intersect=False)
    frame = sim.render_frame(seed=0)
    out["device_ms"]["sphere brute"] = brute_ms(frame["segments"]["rays"], sim.scene["tri_soa"])
    out["rays_digest"]["sphere brute"] = digest(frame["segments"]["rays"])
    rf_env, maps = frame["rf_env"], sim.scan_maps
    map_row, map_col = (torch.from_numpy(m).cuda() for m in imaging.scan_conversion_maps(cfg))
    grid_sample = grid_sample_remap(map_row, map_col, cfg.rf_rows, cfg.rf_cols)
    out["device_ms"]["scanconv"] = graph_ms(lambda: scanconv.scan_convert_forward(rf_env, maps), 1)
    out["device_ms"]["grid_sample"] = graph_ms(lambda: grid_sample(rf_env), 1)
    # K9 on a seeded cotangent of the B-mode image (the fit step's backward)
    g_bm = torch.randn((cfg.bmode_rows, cfg.bmode_cols), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(7))
    out["device_ms"]["scanconv_bwd"] = graph_ms(lambda: scanconv.scan_convert_backward(g_bm, maps), 1)
    out["device_ms"]["scanconv_bwd_cold"] = cold_graph_ms(
        lambda: scanconv.scan_convert_backward(g_bm, maps))
    # and where an RF cell takes up to 30 taps: a 400 x 500 image over 64 RF columns
    fine = small_test_config(bmode_rows=400, bmode_cols=500)
    fine_maps = scanconv.scan_maps(*imaging.scan_conversion_maps(fine), fine.rf_rows, fine.rf_cols,
                                   device="cuda")
    g_fine = torch.randn((fine.bmode_rows, fine.bmode_cols), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(8))
    out["device_ms"]["scanconv_bwd_fine"] = graph_ms(
        lambda: scanconv.scan_convert_backward(g_fine, fine_maps), 1)

    profile_frames(PROFILED)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
