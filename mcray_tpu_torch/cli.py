"""Command-line frame renderer (the ``render`` command of ``mcray_tpu.cli``).

Renders N frames of a scene, saves the last B-mode as a PNG and prints the
time per frame and the rays/s. On a CUDA device the frame time is taken
with CUDA events around the render; on the CPU with the host clock.

Usage:
    python -m mcray_tpu_torch.cli path/to/scene.scene --device cuda --out out.png
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from mcray_tpu.utils.image_io import save_png

from .config import SimConfig
from .models.simulator import Simulator
from .scene.compile import load_and_compile


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
    p = argparse.ArgumentParser(description="PyTorch/CUDA MC ultrasound renderer")
    p.add_argument("scene", help=".scene JSON path (reference schema)")
    p.add_argument("--out", default="bmode.png")
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--elements", type=int, default=None, help="override scanline count")
    p.add_argument("--samples", type=int, default=None, help="override MC paths/scanline")
    p.add_argument("--device", default="cpu", help="torch device: cpu or cuda")
    p.add_argument("--intersect-mode", default=None,
                   choices=["listed", "culled", "staged", "grouped"],
                   help="cluster closest-hit kernel on scenes of 2,048 triangles and up "
                        "(default: listed; grouped is not ported yet)")
    p.add_argument("--intersect-tile-r", type=int, default=None,
                   help="rays per intersect packet (default 512 with clusters)")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)

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


if __name__ == "__main__":
    sys.exit(main())
