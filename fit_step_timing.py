#!/usr/bin/env python3
"""Time the port's material-fit step on one NVIDIA GPU, in one short process.

    python3 fit_step_timing.py [--tree DIR] [--steps N]

Imports ``mcray_tpu_torch`` from DIR (default: the directory of this
script), so one copy of the script times two checkouts in turns: run it
alternately with ``--tree`` of each, one process per run. The times
and the profile are taken as ``chip_smoke.py`` takes them, by
``mcray_tpu_torch/utils/benchmarking.py`` of this script's checkout. The
set-up is ``chip_smoke.py``'s fit phase: the sphere at ``SimConfig()`` widths in soft +
trilinear mode, the target frame from fixed draws, LIVER's attenuation
doubled and fitted back by Adam; one step to warm up, then N steps timed by
CUDA events, then ``torch.profiler`` over 3 steps for the device's view.
Prints one JSON line: the tree, the card's ``nvidia-smi`` name and power
limit, the step's median, min and max ms, the device busy ms and device
operations per step. Needs the card; without one it exits non-zero.
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
busy_view, event_ms, nvidia_smi = _timing.busy_view, _timing.event_ms, _timing.nvidia_smi


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=here, help="checkout whose mcray_tpu_torch is timed")
    parser.add_argument("--steps", type=int, default=10)
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fit_step_timing: torch.cuda.is_available() is false; this needs an NVIDIA GPU")

    from mcray_tpu_torch.config import SimConfig
    from mcray_tpu_torch.models.simulator import Simulator
    from mcray_tpu_torch.models.trainer import MaterialFitter
    from mcray_tpu_torch.ops import physics
    from mcray_tpu_torch.scene.compile import load_and_compile

    import mcray_tpu_torch
    if not os.path.abspath(mcray_tpu_torch.__file__).startswith(tree + os.sep):
        raise SystemExit(f"fit_step_timing: imported {mcray_tpu_torch.__file__}, not from {tree}")
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    pack = load_and_compile(os.path.join(tree, "assets", "sphere", "sphere.scene"))
    cfg = SimConfig(soft_scattering=True, trilinear_texture=True)
    sim = Simulator(pack, cfg, device="cuda", seed=0)
    row, col = 3, physics.ATTENUATION  # LIVER, the box medium
    draws = sim.draws(0)
    with torch.no_grad():
        target = sim.render_frame(draws=draws)["bmode"]
    start = pack.materials.copy()
    start[row, col] *= 2.0
    fit = MaterialFitter.from_simulator(sim, start, target, trainable=(col,),
                                        trainable_rows=[row], fixed_frame=draws)
    fit.step(draws)
    step_ms = event_ms(lambda: fit.step(draws), args.steps)
    view = busy_view(lambda: fit.step(draws), 3)
    print(json.dumps({
        "tree": tree, "gpu": smi, "steps": args.steps,
        "step_ms_median": statistics.median(step_ms), "step_ms_min": min(step_ms),
        "step_ms_max": max(step_ms), "step_ms": step_ms,
        "busy_ms": view["busy_ms"], "device_operations": view["operations"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
