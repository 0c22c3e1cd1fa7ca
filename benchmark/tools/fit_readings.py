#!/usr/bin/env python3
"""The readings the fit cell's output limit is set from, in one process on
the card.

    python3 benchmark/tools/fit_readings.py --workload sphere_soft.fit --seeds 12 --controls 12

For each seed: the program (the cell's entry, built from the seed as a run
builds it) fits ``sample`` requests of the cell's traffic, and the last step
of each is compared with the reference's, as a run compares them: the
step's frames, its masked gradient and its update, each a relative L2 gap;
the program's reading is the widest, ``rel_l2_max``. Beside it, on every
seed, a stale gradient: the program's gradient of the step before the last
against the reference's gradient of the last step. On the first
``controls`` seeds the control: the reference held in bfloat16 between
steps, against the reference, on the same three answers. One JSON line a
seed. Needs the card.
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
    p.add_argument("--workload", default="sphere_soft.fit")
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=3_000_000_019)
    args = p.parse_args()

    import torch

    from benchmark.harness import cell, check, runner, traffic

    if not torch.cuda.is_available():
        print("fit_readings: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = cell.workload(cell.benchmark(), args.workload)
    conf, mix = cell.config(w["config"]), cell.traffic(w["traffic"])
    print(json.dumps({"device": torch.cuda.get_device_name(0), "workload": args.workload}),
          flush=True)
    names = ("frames", "grad", "update")

    def gaps(got: dict, want: dict) -> dict:
        return {k: check.rel_l2(got[k], want[k]) for k in names}

    for i in range(args.seeds):
        t0 = time.perf_counter()
        seed = args.first_seed + 7919 * i
        ctx = runner.Context(conf, conf["acquisition"], seed, "cuda")
        wl = traffic.make(mix, ctx)
        wl.warm()
        items = []
        for _ in range(mix["sample"]):
            fit_seed = traffic.seed_words(ctx.streams["requests"])
            wl.fit.state = wl.start(fit_seed)
            wl.fit.run(wl.n_steps - 1, fit_seed, verbose=False)
            before, prev = wl.fit.state, wl.fit.last_grad.clone()
            wl.fit.run(1, fit_seed, verbose=False)
            items.append({"seed": fit_seed, "before": before, "prev": prev,
                          "frames": wl.fit.last_frames.clone(), "grad": wl.fit.last_grad.clone(),
                          "after": wl.fit.state.materials})
        bad = int(ctx.guard.bad)
        wl.free()
        gc.collect()
        torch.cuda.empty_cache()
        ref = wl.reference()
        row = {"seed": seed, "bad_frames": bad, "program": [], "stale_grad": []}
        if i < args.controls:
            row["control"] = []
        for item in items:
            want = wl.answers(item, ref)
            want = {"frames": want["bmode"], "grad": want["grad"].reshape(1, -1),
                    "update": want["update"].reshape(1, -1)}
            got = {"frames": item["frames"], "grad": item["grad"].reshape(1, -1),
                   "update": (item["after"] - item["before"].materials).reshape(1, -1)}
            row["program"].append(gaps(got, want))
            row["stale_grad"] += check.rel_l2(item["prev"].reshape(1, -1), want["grad"])
            if i < args.controls:
                ctl = wl.answers(item, ref, control=True)
                ctl = {"frames": ctl["bmode"], "grad": ctl["grad"].reshape(1, -1),
                       "update": ctl["update"].reshape(1, -1)}
                row["control"].append(gaps(ctl, want))
        row["rel_l2_max"] = max(max(g) for r in row["program"] for g in r.values())
        if "control" in row:
            row["control_rel_l2_max"] = [max(max(g) for g in r.values()) for r in row["control"]]
        row["seconds"] = time.perf_counter() - t0
        row["peak_bytes"] = torch.cuda.max_memory_allocated()
        print(json.dumps(row), flush=True)
        del ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
