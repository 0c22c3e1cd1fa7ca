#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port on one NVIDIA GPU: one JSON line.

    python3 bench_torch.py

The counterpart of ``bench.py`` (which times the JAX package on a TPU), in
the same shape: ``metric`` ``rays_per_s_per_chip_sphere``, ``value``,
``unit``, ``vs_baseline`` and ``extra``.

- ``value``: the sphere's path-bounce queries a frame (512 elements x 5
  paths x 10 bounces = 25,600) over the time a frame of
  ``Simulator.make_chained_batch(8, 16)`` takes: 16 steps of 8 frames, each
  step replayed from a CUDA graph, timed by CUDA events around the call
  (median of CHAIN_CALLS calls, divided by its 128 frames).
- ``vs_baseline``: ``value`` over the rays/s of the single-threaded C++
  re-implementation of the reference's frame (``native/ref_baseline.cpp``,
  driven by ``mcray_tpu_torch/utils/ref_baseline.py``), built and timed on
  the card's host in the same run: wall against wall (``headline_basis``).
- ``extra``: per frame of the chained call the device's busy ms,
  operations and idle share (``benchmarking.busy_view``) and the wall ms;
  the launches of each kernel inside one call's replays (by the profiler's
  kernel names); a single frame (``render_frame`` with its B-mode copied to
  the host: median, min and max of SINGLE_FRAMES frames after warm-up) and
  its device busy ms and operations; the ircad_hd row (a
  ``make_chained_batch(8, 8)`` on the 123,224-triangle phantom, with its own
  C++ baseline); the sphere frame's stage table (``roofline.stage_table``);
  the set-up apart (the graph's capture ms, the device memory its pool
  keeps and the peak memory allocated);
  the card's name and power limit; and ``correct``: each chained call's
  last step bitwise ``render_frames`` of the same keys run eagerly, and
  every B-mode finite, non-negative and zero outside the fan.

It needs the card and exits non-zero, printing no result, without one. It
carries no number measured elsewhere: every number in the line is taken in
this run.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SPHERE_SCENE = os.path.join(REPO, "assets", "sphere", "sphere.scene")
IRCAD_HD_SCENE = os.path.join(REPO, "assets", "ircad11_hd", "santi-liver-hd.scene")
IRCAD_HD_ASSETS = os.path.join(REPO, "build", "mcray_tpu_torch", "ircad11_hd")
BATCH, N_CHAIN, HD_CHAIN = 8, 16, 8
CHAIN_CALLS = 5          # chained calls timed by events (the median is the headline)
PROFILED_CALLS = 2       # chained calls profiled for the device's view
SINGLE_FRAMES = 30
BASELINE_FRAMES = 5
# the kernels of the main path, by the profiler's names, and their launches a step
STEP_KERNELS = {"intersect_listed_kernel": 10, "march_kernel": 1, "postproc_kernel": 1,
                "scan_convert_kernel": 1}


def fan_outside(sim) -> torch.Tensor:
    """(bmode_rows, bmode_cols) mask of the pixels no RF sample reaches."""
    table = sim.scan_maps.table[:, :, : sim.cfg.bmode_cols]
    return ((table[:, 1] == 0) & (table[:, 2] == 0)) | ((table[:, 4] == 0) & (table[:, 5] == 0))


def good_bmodes(sim, bmode: torch.Tensor) -> bool:
    """Every frame of ``bmode`` finite, non-negative, zero outside the fan."""
    outside = fan_outside(sim)
    return bool(torch.isfinite(bmode).all()) and float(bmode.min()) >= 0.0 and float(
        bmode[:, outside].abs().max()) == 0.0


def chained_row(sim, batch: int, n_chain: int, seeds) -> dict:
    """Capture, time and profile ``sim.make_chained_batch(batch, n_chain)``,
    and check each timed call's last step against ``render_frames`` of its
    keys run eagerly."""
    from mcray_tpu_torch.utils import profiling, rng
    from mcray_tpu_torch.utils.benchmarking import busy_view, event_ms

    frames = batch * n_chain
    chained = sim.make_chained_batch(batch, n_chain)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reserved = torch.cuda.memory_reserved()
    chained(seeds[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()  # what stays reserved is the graph's pool
    setup = {"capture_ms": profiling.last_ms("chained.capture"),
             "peak_allocated_mib": peak / 2**20,
             "graph_mib": (torch.cuda.memory_reserved() - reserved) / 2**20}

    correct = True
    ms = []
    for seed in seeds:
        got = []
        ms += event_ms(lambda: got.append(chained(seed)), 1)
        last = got[0].clone()
        keys = rng.fold_in(rng.prng_key(seed),
                           (n_chain - 1) * batch + torch.arange(batch, dtype=torch.int64))
        eager = sim.render_frames(keys)["bmode"]
        correct &= torch.equal(last, eager) and int(chained.carry) == 0
        correct &= good_bmodes(sim, last)
    call_ms = statistics.median(ms)
    expect = {k: v * n_chain for k, v in STEP_KERNELS.items()}
    view = busy_view(lambda: chained(seeds[0]), PROFILED_CALLS, expect=expect)
    launches = {k: sum(v for name, v in view["count_by_name"].items() if k in name)
                for k in STEP_KERNELS}
    return {
        "frames_per_call": frames, "call_ms": call_ms, "call_ms_all": ms,
        "frame_ms": call_ms / frames, "rays_per_s": sim.rays_per_frame / (call_ms / frames / 1e3),
        "frame_device_busy_ms": view["busy_ms"] / frames,
        "frame_device_operations": view["operations"] / frames,
        "idle_share": 1.0 - view["busy_ms"] / call_ms,
        "replay_launches": launches,
        "correct": correct, **setup,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_torch: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from mcray_tpu_torch.config import SimConfig
    from mcray_tpu_torch.models.simulator import Simulator
    from mcray_tpu_torch.scene.compile import load_and_compile
    from mcray_tpu_torch.utils import ref_baseline, roofline
    from mcray_tpu_torch.utils.benchmarking import busy_view, nvidia_smi

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    cfg = SimConfig()
    pack = load_and_compile(SPHERE_SCENE)
    sim = Simulator(pack, cfg, device="cuda", seed=0)

    sphere = chained_row(sim, BATCH, N_CHAIN, [10 + i for i in range(CHAIN_CALLS)])

    # the single frame as a client takes it: rendered and its B-mode copied to the host
    for seed in (0, 1):
        sim.render_frame(seed)["bmode"].cpu()
    singles = []
    for i in range(SINGLE_FRAMES):
        t0 = time.perf_counter()
        sim.render_frame(100 + i)["bmode"].cpu()
        singles.append((time.perf_counter() - t0) * 1e3)
    single_view = busy_view(lambda: sim.render_frame(7), 3,
                            expect={"intersect_listed_kernel": cfg.max_depth})

    pack_hd = load_and_compile(IRCAD_HD_SCENE, asset_dir=IRCAD_HD_ASSETS)
    sim_hd = Simulator(pack_hd, cfg, device="cuda", seed=0)
    hd = chained_row(sim_hd, BATCH, HD_CHAIN, [10, 11, 12])

    table = roofline.stage_table(sim, [0])

    lib = ref_baseline.build()
    base = ref_baseline.run(pack, cfg, frames=BASELINE_FRAMES, lib_path=lib)
    base_hd = ref_baseline.run(pack_hd, cfg, frames=BASELINE_FRAMES, lib_path=lib)

    value = sphere["rays_per_s"]
    result = {
        "metric": "rays_per_s_per_chip_sphere",
        "value": value,
        "unit": "ray-casts/s",
        "vs_baseline": value / base["rays_per_s"],
        "extra": {
            "headline_basis": "wall against wall: CUDA events around the synchronised chained "
                              "call on the card against the C++ frame's host wall clock on the "
                              "card's host",
            "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi,
            "batch": BATCH, "n_chain": N_CHAIN,
            "elements": cfg.transducer_elements, "samples": cfg.samples_per_element,
            "bounces": cfg.max_depth, "rays_per_frame": sim.rays_per_frame,
            "frames_per_s": 1e3 / sphere["frame_ms"],
            "frame_ms_wall_chained": sphere["frame_ms"],
            "chained_call_ms": sphere["call_ms_all"],
            "frame_device_busy_ms": sphere["frame_device_busy_ms"],
            "frame_device_operations": sphere["frame_device_operations"],
            "chained_idle_share": sphere["idle_share"],
            "chained_replay_launches": sphere["replay_launches"],
            "single_frame_ms": statistics.median(singles),
            "single_frame_ms_min": min(singles), "single_frame_ms_max": max(singles),
            "single_frames": len(singles),
            "single_frame_device_ms": single_view["busy_ms"],
            "single_frame_device_operations": single_view["operations"],
            "setup": {"graph_capture_ms": sphere["capture_ms"],
                      "peak_allocated_mib": sphere["peak_allocated_mib"],
                      "graph_mib": sphere["graph_mib"],
                      "ircad_hd_graph_capture_ms": hd["capture_ms"],
                      "ircad_hd_peak_allocated_mib": hd["peak_allocated_mib"]},
            "ircad_hd_triangles": pack_hd.n_triangles,
            "ircad_hd_rays_per_s": hd["rays_per_s"],
            "ircad_hd_frame_ms": hd["frame_ms"],
            "ircad_hd_frame_device_busy_ms": hd["frame_device_busy_ms"],
            "ircad_hd_frame_device_operations": hd["frame_device_operations"],
            "ircad_hd_idle_share": hd["idle_share"],
            "ircad_hd_vs_cpp_baseline": hd["rays_per_s"] / base_hd["rays_per_s"],
            "sphere_frame_device_ms": table["full_frame_ms"],
            "frame_gflops": table["frame_gflops"],
            "frame_roofline_ms": table["frame_roofline_ms"],
            "frame_pct_of_roofline": table["frame_pct_of_roofline"],
            "stage_device_ms": {r["stage"]: r["ms"] for r in table["stages"]},
            "stage_pct_peak": {r["stage"]: r["pct_peak_compute"] for r in table["stages"]},
            "stage_bound": {r["stage"]: r["bound"] for r in table["stages"]},
            "baseline": "single-thread C++ re-implementation of the reference's frame on the "
                        "card's host (native/ref_baseline.cpp, mcray_tpu_torch/utils/"
                        "ref_baseline.py)",
            "baseline_frame_ms": base["frame_ms"], "baseline_rays_per_s": base["rays_per_s"],
            "baseline_ircad_hd_frame_ms": base_hd["frame_ms"],
            "correct": sphere["correct"] and hd["correct"],
        },
    }
    print(json.dumps(result))
    return 0 if result["extra"]["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
