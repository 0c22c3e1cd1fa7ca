#!/usr/bin/env python3
"""Time the port's closest hits and scan conversion on one NVIDIA GPU, in one short process.

    python3 cluster_timing.py [--tree DIR]

Imports ``mcray_tpu_torch`` from DIR (default: the directory of this
script), so one copy of the script times two checkouts in turns: run it
alternately with ``--tree`` of each, one process per run. The times
and the profile are taken as ``chip_smoke.py`` takes them, by
``device_timing.py`` beside this script. At ``SimConfig()``
widths it renders seed 0 of the sphere and the ircad_hd frames in listed
(K5), culled (K6) and staged (K7) mode and of the mega frame in listed mode,
takes each frame's ten bounces of rays, and times the frame's closest-hit
kernel on them replayed from a CUDA graph (the launches back to back,
without the host's time to launch each): device ms per launch, mean over
the bounces. The same for the brute closest hit (K1) on the sphere brute
frame's bounces and on the ircad_hd listed frame's, and for the scan
conversion (K4) on the sphere brute frame's RF image beside ``grid_sample``.
The sphere (listed and brute), ircad_hd (listed, culled and staged) and
mega listed frames are then timed by CUDA events (5 frames) and profiled by
``torch.profiler`` (3 frames): device busy ms, the idle share against the
unprofiled median, device operations and the closest-hit kernel's ms per
frame. Prints one JSON line: the tree, the card's ``nvidia-smi`` name and
power limit, and the numbers, with a digest of each ray set so that two
trees' runs can be seen to time the same rays. Needs the card; without one
it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

from device_timing import busy_view, event_ms, graph_ms, grid_sample_remap, nvidia_smi

SCENES = {  # name: (scene file, directory its meshes are generated into)
    "sphere": (("assets", "sphere", "sphere.scene"), None),
    "ircad_hd": (("assets", "ircad11_hd", "santi-liver-hd.scene"),
                 ("build", "mcray_tpu_torch", "ircad11_hd")),
    "mega": (("assets", "ircad11_mega", "santi-liver-mega.scene"),
             ("build", "mcray_tpu_torch", "ircad11_mega")),
}
RUNS = [("sphere", "listed"), ("sphere", "culled"), ("sphere", "staged"), ("ircad_hd", "listed"),
        ("ircad_hd", "culled"), ("ircad_hd", "staged"), ("mega", "listed")]
PROFILED = [("sphere", "listed"), ("sphere", "brute"), ("ircad_hd", "listed"), ("ircad_hd", "culled"),
            ("ircad_hd", "staged"), ("mega", "listed")]
# the closest-hit kernel of each mode, by its name in the profile
KERNEL_NAME = {"brute": "intersect_closest_kernel", "listed": "intersect_listed_kernel",
               "culled": "intersect_culled_kernel", "staged": "intersect_staged_kernel"}


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=here, help="checkout whose mcray_tpu_torch is timed")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("cluster_timing: torch.cuda.is_available() is false; this needs an NVIDIA GPU")

    import mcray_tpu_torch
    from mcray_tpu_torch.config import SimConfig
    from mcray_tpu_torch.models.simulator import Simulator
    from mcray_tpu_torch.ops import clusters, imaging
    from mcray_tpu_torch.ops.cuda import (intersect, intersect_culled, intersect_listed,
                                          intersect_staged, scanconv)
    from mcray_tpu_torch.ops.geometry import NO_HIT_T
    from mcray_tpu_torch.scene.compile import load_and_compile

    if not os.path.abspath(mcray_tpu_torch.__file__).startswith(tree + os.sep):
        raise SystemExit(f"cluster_timing: imported {mcray_tpu_torch.__file__}, not from {tree}")
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def kernel_calls(sim, rays):
        """(kernel, arguments) of the frame's closest hit at each bounce."""
        packed, mode = sim.culled_tris
        tile_r = sim.intersect_tile_r
        calls = []
        for d in range(rays.shape[0]):
            o, s = rays[d][0:3].T.contiguous(), rays[d][3:6].T.contiguous()
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
    for scene, mode in RUNS:
        if scene not in packs:
            path, assets = SCENES[scene]
            packs[scene] = load_and_compile(os.path.join(tree, *path),
                                            asset_dir=assets and os.path.join(tree, *assets))
        sim = sims[scene, mode] = Simulator(packs[scene], cfg, device="cuda", seed=0,
                                            intersect_mode=mode)
        rays = sim.render_frame(seed=0)["segments"]["rays"]
        calls = kernel_calls(sim, rays)
        key = f"{scene} {mode}"
        out["device_ms"][key] = graph_ms(lambda c=calls: [k(*a) for k, a in c], len(calls))
        out["rays_digest"][key] = digest(rays)
        if key == "ircad_hd listed":  # K1 on the same rays
            out["device_ms"]["ircad_hd brute"] = brute_ms(rays, sim.scene["tri_soa"])

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

    out["frames"] = {}
    for scene, mode in PROFILED:
        sim = sims[scene, mode]
        seeds = iter(range(100, 105))
        frame_ms = event_ms(lambda: sim.render_frame(seed=next(seeds)), 5)
        view = busy_view(lambda: sim.render_frame(seed=7), 3)
        med = statistics.median(frame_ms)
        out["frames"][f"{scene} {mode}"] = {
            "median_ms": med, "min_ms": min(frame_ms), "max_ms": max(frame_ms),
            "busy_ms": view["busy_ms"], "idle_share": 1 - view["busy_ms"] / med,
            "device_operations": view["operations"],
            "kernel_ms": sum(v for k, v in view["by_name"].items() if KERNEL_NAME[mode] in k)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
