#!/usr/bin/env python3
"""The readings a cell's output limit is set from, in one process on the card.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 12 --controls 12 --witnesses 3 --seconds 3

For each seed: the program (the cell's entry, built from the seed as a run
builds it) serves the cell's traffic for a short window at the cell's own
load, and its sampled answers are compared with the reference, as a run
compares them: the program's reading is the widest per-frame gap,
``rel_l2_max``. Beside it, on every seed, a stale answer (the program's
first sampled answer against the reference of the second's keys: a call
that returns its previous state). On the first ``controls`` seeds the
control (the reference held in bfloat16 between steps, against the
reference); on the first ``witnesses`` seeds two witnesses that are not
limits: the program with the brute closest hit instead of the listed one
(ties go to the lower triangle index, so a few paths part), and the program
against the reference whose packets walk their cluster lists four rays at a
time, as the listed kernel's blocks do (``group4``). One JSON line a seed.
Needs the card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[0] = ROOT


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=12)
    p.add_argument("--witnesses", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_017)
    args = p.parse_args()

    import torch

    from benchmark.harness import cell, check, runner, traffic
    from mcray_tpu_torch.config import SimConfig
    from mcray_tpu_torch.models.simulator import Simulator
    from mcray_tpu_torch.scene.compile import load_and_compile

    if not torch.cuda.is_available():
        print("readings: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = cell.workload(cell.benchmark(), args.workload)
    conf, mix = cell.config(w["config"]), cell.traffic(w["traffic"])
    print(json.dumps({"device": torch.cuda.get_device_name(0), "workload": args.workload}),
          flush=True)
    reference = None

    for i in range(args.seeds):
        t0 = time.perf_counter()
        seed = args.first_seed + 7919 * i
        ctx = runner.Context(conf, conf["acquisition"], seed, "cuda")
        if reference is None:
            reference = ctx.reference
        reference.texture(ctx.texture_seed)
        ctx.reference = reference
        wl = traffic.make(mix, ctx)
        wl.warm()
        t_w, n = time.perf_counter(), 0
        while time.perf_counter() - t_w < args.seconds:
            wl.request()
            n += 1
        bad = int(ctx.guard.bad)
        wl.free()
        gc.collect()
        torch.cuda.empty_cache()
        pairs = wl.compare()
        programs = [prog for prog, _ in pairs]
        refs = [ref["bmode"] for _, ref in pairs]
        gaps = [g for prog, ref in zip(programs, refs) for g in check.rel_l2(prog, ref)]
        row = {"seed": seed, "requests": n, "bad_frames": bad, "rel_l2_max": max(gaps),
               "rel_l2": gaps, "stale_rel_l2": check.rel_l2(programs[0], refs[1])}
        row["stale_rel_l2_min"] = min(row["stale_rel_l2"])
        keys = wl.keys()
        if i < args.controls:
            ctl = [g for k, ref in zip(keys, refs)
                   for g in check.rel_l2(reference.render(k, control=True)["bmode"], ref)]
            row.update({"control_rel_l2_min": min(ctl), "control_rel_l2": ctl})
        if i < args.witnesses:
            pack = load_and_compile(ctx.scene_path, asset_dir=ctx.mesh_dir)
            brute = Simulator(pack, SimConfig(**ctx.acq), device="cuda", seed=ctx.texture_seed,
                              use_culled_intersect=False)
            bgaps = [g for k, ref in zip(keys, refs)
                     for g in check.rel_l2(brute.render_frames(k)["bmode"], ref)]
            del brute
            grouped = [g for prog, k in zip(programs, keys)
                       for g in check.rel_l2(prog, reference.render(k, group=4)["bmode"])]
            row.update({"group4_rel_l2": grouped, "brute_rel_l2_max": max(bgaps),
                        "brute_rel_l2": bgaps})
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
