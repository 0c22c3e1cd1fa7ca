#!/usr/bin/env python3
"""Time the chained batch's graph launch on one NVIDIA GPU, in one process: one JSON line.

    python3 launch_probe.py [--workload sphere.chained] [--seed N] [--calls 8]

Builds the ``Simulator`` and ``make_chained_batch`` of a benchmark cell
(``benchmark/harness/runner.py``'s set-up, the cell's batch and chain) and
reads, from the program's own host spans (``utils/profiling.py``):

- ``capture_call``: the first call, which captures the step graph: its
  replays right after the capture (µs a ``CUDAGraph.replay()``), and the
  ``chained.capture`` span;
- ``unprofiled``: ``--calls`` calls before any profiler: µs a replay
  (median, mean, most), a call's host ms a frame until it returns (the
  launches: ``chained.call``) and until the device has finished (wall);
- ``marks``: the step graph with its stage marks against the same step
  captured with ``profiling.mark`` a no-op, ``--calls`` calls each in turns,
  timed by CUDA events (ms a frame), with each graph's nodes;
- ``after_profiler``: one call under ``torch.profiler`` (CUDA activity, as
  the benchmark's traced run), then ``--calls`` calls: as ``unprofiled``.

Each section also gives the card's SM clock (MHz, ``nvidia-smi``) at its end.

It needs a CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def replay_us(spans, request: int) -> list[float]:
    return [(s.end_ns - s.start_ns) / 1e3 for s in spans
            if s.name == "chained.replay" and s.request == request]


def summary(values) -> dict:
    return {"median": statistics.median(values), "mean": statistics.fmean(values),
            "most": max(values), "n": len(values)}


def sm_clock_mhz() -> str | None:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def timed_calls(chained, seeds, frames: int) -> dict:
    """Host µs a replay, and host ms a frame of one synchronised call a seed:
    until the call returns (its launches) and until the device is done."""
    from mcray_tpu_torch.utils import profiling

    replays, launch, wall = [], [], []
    for seed in seeds:
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        chained(seed)
        torch.cuda.synchronize()
        wall.append((time.perf_counter_ns() - t0) / 1e6 / frames)
        call = [s for s in profiling.spans() if s.name == "chained.call"][-1]
        replays += replay_us(profiling.spans(), call.request)
        launch.append((call.end_ns - call.start_ns) / 1e6 / frames)
    return {"replay_us": summary(replays), "launch_ms_a_frame": summary(launch),
            "wall_ms_a_frame": summary(wall), "sm_clock": sm_clock_mhz()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="sphere.chained")
    ap.add_argument("--seed", type=int, default=3100000001)
    ap.add_argument("--calls", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("launch_probe.py needs a CUDA device")

    from benchmark.harness import cell, runner, traffic
    from mcray_tpu_torch.utils import profiling

    spec = cell.benchmark()
    w = cell.workload(spec, args.workload)
    conf, mix = cell.config(w["config"]), cell.traffic(w["traffic"])
    ctx = runner.Context(conf, conf["acquisition"], args.seed, "cuda")
    sim = ctx.simulator()
    batch, n_chain = mix["batch"], mix["n_chain"]
    frames = batch * n_chain
    seeds = [traffic.seed_words(ctx.streams["requests"]) for _ in range(4 * args.calls + 3)]
    out = {"workload": args.workload, "batch": batch, "n_chain": n_chain,
           "device": torch.cuda.get_device_name()}

    marked = sim.make_chained_batch(batch, n_chain)
    nodes0 = profiling.counters().get("chained.graph_nodes", 0)
    marked(seeds.pop())
    torch.cuda.synchronize()
    spans = profiling.spans()
    call = [s for s in spans if s.name == "chained.call"][-1]
    out["capture_call"] = {"replay_us": summary(replay_us(spans, call.request)),
                           "capture_ms": profiling.last_ms("chained.capture"),
                           "sm_clock": sm_clock_mhz()}
    marked_nodes = profiling.counters()["chained.graph_nodes"] - nodes0
    out["unprofiled"] = timed_calls(marked, [seeds.pop() for _ in range(args.calls)], frames)

    # the same step captured with the marks a no-op
    mark = profiling.mark
    profiling.mark = lambda stage, device: None
    try:
        plain = sim.make_chained_batch(batch, n_chain)
        plain(seeds.pop())
    finally:
        profiling.mark = mark
    torch.cuda.synchronize()
    plain_nodes = profiling.counters()["chained.graph_nodes"] - nodes0 - marked_nodes
    ms = {"marked": [], "plain": []}
    for k in range(args.calls):
        for name, chained in (("marked", marked), ("plain", plain))[:: 1 if k % 2 else -1]:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            chained(seeds.pop())
            end.record()
            end.synchronize()
            ms[name].append(start.elapsed_time(end) / frames)
    out["marks"] = {"marked_ms_a_frame": summary(ms["marked"]),
                    "plain_ms_a_frame": summary(ms["plain"]),
                    "median_cost_pct": 100.0 * (statistics.median(ms["marked"])
                                                / statistics.median(ms["plain"]) - 1.0),
                    "marked_nodes": marked_nodes, "plain_nodes": plain_nodes,
                    "sm_clock": sm_clock_mhz()}

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        marked(seeds.pop())
        torch.cuda.synchronize()
    out["after_profiler"] = timed_calls(marked, [seeds.pop() for _ in range(args.calls)], frames)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
