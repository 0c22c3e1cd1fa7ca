"""Command line: the ``render`` and ``fit`` commands of ``mcray_tpu.cli``.

``render`` (the default) renders N frames of a scene, saves the last B-mode
as a PNG and prints the time per frame and the rays/s. On a CUDA device the
frame time is taken with CUDA events around the render; on the CPU with the
host clock. ``fit`` perturbs one material parameter and recovers it from the
rendered target by pixel-gradient descent (with checkpoint/resume).

Both run on the card unless ``--device cpu`` is given, and raise where there
is none.

Usage:
    python -m mcray_tpu_torch.cli path/to/scene.scene --out out.png
    python -m mcray_tpu_torch.cli fit path/to/scene.scene --material LIVER --steps 20
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .config import SimConfig
from .models.simulator import Simulator
from .models.trainer import MaterialFitter
from .ops import physics
from .scene.compile import load_and_compile
from .scene.loader import load_scene
from .utils.checkpoint import load_fit_state, save_fit_state
from .utils.image_io import save_png


def _timed_frame(sim: Simulator, seed: int):
    """(render output, frame ms): CUDA events on the card, host clock on the CPU."""
    if sim.device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = sim.render_frame(seed)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = sim.render_frame(seed)
    return out, (time.perf_counter() - t0) * 1e3


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "fit":
        return fit_main(argv[1:])
    p = argparse.ArgumentParser(description="PyTorch/CUDA MC ultrasound renderer")
    p.add_argument("scene", help=".scene JSON path (reference schema)")
    p.add_argument("--out", default="bmode.png")
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--elements", type=int, default=None, help="override scanline count")
    p.add_argument("--samples", type=int, default=None, help="override MC paths/scanline")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain PyTorch versions)")
    p.add_argument("--intersect-mode", default=None,
                   choices=["listed", "culled", "staged", "grouped"],
                   help="cluster closest-hit kernel on scenes of 2,048 triangles and up "
                        "(default: listed; grouped visits each cluster once with the rays "
                        "that reach it: for large scenes and incoherent rays)")
    p.add_argument("--intersect-tile-r", type=int, default=None,
                   help="rays per intersect packet (default 512 with clusters; for grouped, "
                        "of its residual listed pass: a multiple of 128)")
    args = p.parse_args(argv)

    overrides = {}
    if args.elements:
        overrides["transducer_elements"] = args.elements
    if args.samples:
        overrides["samples_per_element"] = args.samples
    cfg = SimConfig(**overrides)

    t0 = time.perf_counter()
    pack = load_and_compile(args.scene)
    sim = Simulator(pack, cfg, device=args.device, seed=args.seed,
                    intersect_mode=args.intersect_mode, intersect_tile_r=args.intersect_tile_r)
    mode = sim.culled_tris[1] if sim.culled_tris is not None else "brute"
    print(f"scene: {pack.n_triangles} triangles, {pack.n_materials} materials "
          f"(setup {time.perf_counter() - t0:.2f}s, device {sim.device}, intersect {mode})")

    times = []
    for i in range(args.frames):
        out, ms = _timed_frame(sim, args.seed + i)
        times.append(ms)
        print(f"frame {i}: {ms:.3f} ms  ({sim.rays_per_frame / ms * 1e3:,.0f} rays/s)")

    bmode = out["bmode"].cpu().numpy()
    save_png(args.out, bmode)
    print(f"saved {args.out}  (min {bmode.min():.3g} max {bmode.max():.3g})")
    if args.frames > 1:
        steady = sorted(times[1:])[len(times[1:]) // 2]
        print(json.dumps({
            "device": torch.cuda.get_device_name(sim.device) if sim.device.type == "cuda" else "cpu",
            "first_frame_ms": times[0],
            "median_steady_frame_ms": steady,
            "rays_per_s": sim.rays_per_frame / steady * 1e3,
        }))
    return 0


def fit_main(argv) -> int:
    """Differentiable fit demo: perturb a material parameter, recover it from
    the rendered target by pixel-gradient descent (with checkpoint/resume)."""
    cols = {
        "impedance": physics.IMPEDANCE, "attenuation": physics.ATTENUATION,
        "mu0": physics.MU0, "mu1": physics.MU1, "sigma": physics.SIGMA,
    }
    p = argparse.ArgumentParser(prog="mcray_tpu_torch.cli fit")
    p.add_argument("scene")
    p.add_argument("--material", required=True, help="material name to perturb+fit")
    p.add_argument("--param", default="attenuation", choices=sorted(cols))
    p.add_argument("--factor", type=float, default=2.0, help="perturbation factor")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--lr", type=float, default=5e-2)
    p.add_argument("--elements", type=int, default=64)
    p.add_argument("--samples", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain PyTorch versions)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    cfg = SimConfig(transducer_elements=args.elements, samples_per_element=args.samples,
                    soft_scattering=True, trilinear_texture=True)
    row = load_scene(args.scene).material_id(args.material)
    col = cols[args.param]
    pack = load_and_compile(args.scene)
    sim = Simulator(pack, cfg, device=args.device, seed=args.seed)

    # fixed randomness: the target and every prediction share one realisation
    draws = sim.draws(args.seed)
    true_val = float(pack.materials[row, col])
    with torch.no_grad():
        target = sim.render_frame(draws=draws)["bmode"]
    perturbed = np.array(pack.materials, np.float32)
    perturbed[row, col] *= args.factor
    print(f"{args.material}.{args.param}: true {true_val:.4g}, start {perturbed[row, col]:.4g}")

    fitter = MaterialFitter.from_simulator(
        sim, perturbed, target, learning_rate=args.lr, trainable=(col,), trainable_rows=[row],
        fixed_frame=draws)
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        fitter.state = load_fit_state(args.checkpoint, fitter.state)
        print(f"resumed at step {fitter.state.step}")
    losses = fitter.run(args.steps, log_every=max(1, args.steps // 10))
    fitted = float(fitter.state.materials[row, col])
    print(json.dumps({
        "param": f"{args.material}.{args.param}",
        "true": round(true_val, 5),
        "initial": round(float(perturbed[row, col]), 5),
        "fitted": round(fitted, 5),
        "loss_first": round(losses[0], 8),
        "loss_last": round(losses[-1], 8),
    }))
    if args.checkpoint:
        save_fit_state(args.checkpoint, fitter.state)
        print(f"checkpoint -> {args.checkpoint}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
