"""Command line: the ``render``, ``serve``, ``sweep`` and ``fit`` commands of
``mcray_tpu.cli``.

``render`` (the default) renders N frames of a scene, saves the last B-mode
as a PNG and prints the time per frame and the rays/s. On a CUDA device the
frame time is taken with CUDA events around the render; on the CPU with the
host clock. ``serve`` renders one frame per JSON request line on stdin and
writes one JSON response line per frame, the next request dispatched while
the last frame drains. ``sweep`` moves the probe by a fixed step per frame
and saves each frame. ``fit`` perturbs one material parameter and recovers
it from the rendered target by pixel-gradient descent (with
checkpoint/resume).

Each runs on the card unless ``--device cpu`` is given, and raises where
there is none.

Usage:
    python -m mcray_tpu_torch.cli path/to/scene.scene --out out.png
    python -m mcray_tpu_torch.cli serve path/to/scene.scene < requests.jsonl
    python -m mcray_tpu_torch.cli sweep path/to/scene.scene --frames 8
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


def _common_args(p: argparse.ArgumentParser) -> None:
    """The flags every rendering command takes."""
    p.add_argument("--elements", type=int, default=None, help="override scanline count")
    p.add_argument("--samples", type=int, default=None, help="override MC paths/scanline")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain PyTorch versions)")


def _overrides(args) -> dict:
    overrides = {}
    if args.elements:
        overrides["transducer_elements"] = args.elements
    if args.samples:
        overrides["samples_per_element"] = args.samples
    return overrides


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    commands = {"fit": fit_main, "serve": serve_main, "sweep": sweep_main}
    if argv and argv[0] in commands:
        return commands[argv[0]](argv[1:])
    return render_main(argv)


def render_main(argv) -> int:
    p = argparse.ArgumentParser(description="PyTorch/CUDA MC ultrasound renderer")
    p.add_argument("scene", help=".scene JSON path (reference schema)")
    p.add_argument("--out", default="bmode.png")
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    _common_args(p)
    p.add_argument("--bvh", action="store_true",
                   help="closest hit by BVH traversal instead of the default kernel")
    p.add_argument("--bug-compat", action="store_true",
                   help="replicate the reference's material-transition bug")
    p.add_argument("--probe", default=None, choices=["convex", "linear", "phased"],
                   help="probe family (default: convex, the reference's)")
    p.add_argument("--envelope", default=None, choices=["reference", "hilbert"],
                   help="envelope detector (default: reference peak-lerp)")
    p.add_argument("--texture", default=None, choices=["procedural", "table"],
                   help="scatterer field backend (default: procedural; table materialises "
                        "the reference's voxel-grid layout)")
    p.add_argument("--scatter-rng", default=None, choices=["boxmuller", "bitsum"],
                   help="per-voxel N(0,1) generator (default: bitsum, a transcendental-free "
                        "dithered binomial; boxmuller a different but statistically "
                        "equivalent speckle realisation)")
    p.add_argument("--save-rf", default=None,
                   help="also save rf_raw, rf_env and bmode of the last frame (npz)")
    p.add_argument("--dump-column", type=int, default=None, metavar="COL",
                   help="print one RF scanline of the last frame (raw and envelope value per "
                        "row), the reference's rf_image::print(column) dump")
    p.add_argument("--intersect-mode", default=None,
                   choices=["listed", "culled", "staged", "grouped"],
                   help="cluster closest-hit kernel on scenes of 2,048 triangles and up "
                        "(default: listed; grouped visits each cluster once with the rays "
                        "that reach it: for large scenes and incoherent rays)")
    p.add_argument("--intersect-tile-r", type=int, default=None,
                   help="rays per intersect packet (default 512 with clusters; for grouped, "
                        "of its residual listed pass: a multiple of 128)")
    args = p.parse_args(argv)

    overrides = _overrides(args)
    for flag, field in (("bug_compat", "bug_compat_material_transition"), ("probe", "probe_type"),
                        ("envelope", "envelope_mode"), ("texture", "texture_mode"),
                        ("scatter_rng", "scatter_rng")):
        if getattr(args, flag):
            overrides[field] = getattr(args, flag)
    cfg = SimConfig(**overrides)

    t0 = time.perf_counter()
    pack = load_and_compile(args.scene)
    sim = Simulator(pack, cfg, device=args.device, seed=args.seed, use_bvh=args.bvh,
                    intersect_mode=args.intersect_mode, intersect_tile_r=args.intersect_tile_r)
    print(f"scene: {pack.n_triangles} triangles, {pack.n_materials} materials "
          f"(setup {time.perf_counter() - t0:.2f}s, device {sim.device}, "
          f"intersect {sim.intersect})")

    times = []
    for i in range(args.frames):
        out, ms = _timed_frame(sim, args.seed + i)
        times.append(ms)
        print(f"frame {i}: {ms:.3f} ms  ({sim.rays_per_frame / ms * 1e3:,.0f} rays/s)")

    bmode = out["bmode"].cpu().numpy()
    save_png(args.out, bmode)
    print(f"saved {args.out}  (min {bmode.min():.3g} max {bmode.max():.3g})")
    if args.save_rf:
        np.savez(args.save_rf, rf_raw=out["rf_raw"].cpu().numpy(),
                 rf_env=out["rf_env"].cpu().numpy(), bmode=bmode)
    if args.dump_column is not None:
        col = args.dump_column
        raw = out["rf_raw"][:, col].cpu().numpy()
        env = out["rf_env"][:, col].cpu().numpy()
        print(f"RF column {col} (row: raw envelope):")
        for r in range(raw.shape[0]):
            print(f"{r:4d}: {raw[r]: .6e} {env[r]: .6e}")
    if args.frames > 1:
        steady = sorted(times[1:])[len(times[1:]) // 2]
        print(json.dumps({
            "device": torch.cuda.get_device_name(sim.device) if sim.device.type == "cuda" else "cpu",
            "first_frame_ms": times[0],
            "median_steady_frame_ms": steady,
            "rays_per_s": sim.rays_per_frame / steady * 1e3,
        }))
    return 0


def _stage(bmode: torch.Tensor):
    """(host copy, event) of a frame just dispatched: on the card an
    asynchronous copy into pinned host memory and an event recorded after
    it, so that draining this frame waits for this frame only; on the CPU
    the frame itself and no event."""
    if bmode.device.type != "cuda":
        return bmode.detach(), None
    host = torch.empty(bmode.shape, dtype=bmode.dtype, pin_memory=True)
    host.copy_(bmode.detach(), non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _drain(frame) -> None:
    """Wait for the frame's event, write its PNG and its response line."""
    host, done, path, t0, idx = frame
    if done is not None:
        done.synchronize()
    save_png(path, host.numpy())
    print(json.dumps({"frame": idx, "out": path,
                      "ms": round((time.perf_counter() - t0) * 1e3, 1)}), flush=True)


def serve_main(argv) -> int:
    """Interactive render service (``mcray_tpu/cli.py:181-263``): the product
    loop the reference's dead input manager aimed at (move probe ->
    re-render, reference src/inputmanager.cpp), as a streaming protocol.

    Reads one JSON request per stdin line,
        {"position": [x,y,z], "angles": [ax,ay,az], "seed": 0, "out": "f.png"}
    (every field optional: the scene's pose, the request's index as seed,
    ``<out-prefix>_<index>.png``), and after one warm frame prints
    {"ready": true, "triangles": n}, then one {"frame", "out", "ms"} line per
    frame and {"error": "bad request: ..."} for a line it cannot render; blank
    lines are skipped. Frame i is dispatched before frame i - 1 is drained:
    on the card each frame's B-mode goes by an asynchronous copy into pinned
    host memory behind an event of its own, and the drain waits on that
    event only, then writes the PNG while frame i runs. ``ms`` runs from
    dispatch to drain."""
    p = argparse.ArgumentParser(prog="mcray_tpu_torch.cli serve")
    p.add_argument("scene")
    _common_args(p)
    p.add_argument("--out-prefix", default="serve")
    args = p.parse_args(argv)
    cfg = SimConfig(**_overrides(args))
    pack = load_and_compile(args.scene)
    sim = Simulator(pack, cfg, device=args.device)
    pos0 = np.asarray(pack.transducer_position, np.float32)
    ang0 = np.asarray(pack.transducer_angles, np.float32)

    sim.render_frame(0)  # warm
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)
    print(json.dumps({"ready": True, "triangles": pack.n_triangles}), flush=True)

    pending = None  # (host B-mode, event, out path, t dispatch, frame index)
    idx = 0
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            pos = np.asarray(req.get("position", pos0), np.float32).reshape(3)
            ang = np.asarray(req.get("angles", ang0), np.float32).reshape(3)
            seed = int(req.get("seed", idx))
            path = str(req.get("out", f"{args.out_prefix}_{idx:04d}.png"))
            t0 = time.perf_counter()
            out = sim.render_frame(seed, position=pos, angles=ang)
        except Exception as e:  # a malformed request must not end the stream
            print(json.dumps({"error": f"bad request: {e}"}), flush=True)
            continue
        frame = (*_stage(out["bmode"]), path, t0, idx)
        # overlap: this frame runs on the card while the previous one is written
        if pending is not None:
            _drain(pending)
        pending = frame
        idx += 1
    if pending is not None:
        _drain(pending)
    return 0


def sweep_main(argv) -> int:
    """Scripted probe-pose sweep (``mcray_tpu/cli.py:266-315``): frame i
    renders at the scene's pose + i x (``--delta-pos``, ``--delta-angles``)
    with seed ``--seed`` + i and is saved as ``<out-prefix>_<i>.png``."""
    p = argparse.ArgumentParser(prog="mcray_tpu_torch.cli sweep")
    p.add_argument("scene")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--delta-pos", type=float, nargs=3, default=[0.0, 0.0, 0.2],
                   help="per-frame probe translation (world units)")
    p.add_argument("--delta-angles", type=float, nargs=3, default=[0.0, 0.0, 0.0],
                   help="per-frame probe rotation (degrees, reference order x,y,z)")
    p.add_argument("--out-prefix", default="sweep")
    p.add_argument("--seed", type=int, default=0)
    _common_args(p)
    args = p.parse_args(argv)
    cfg = SimConfig(**_overrides(args))
    pack = load_and_compile(args.scene)
    sim = Simulator(pack, cfg, device=args.device)
    pos0 = np.asarray(pack.transducer_position, np.float32)
    ang0 = np.asarray(pack.transducer_angles, np.float32)
    dp = np.asarray(args.delta_pos, np.float32)
    da = np.asarray(args.delta_angles, np.float32)
    for i in range(args.frames):
        t0 = time.perf_counter()
        out = sim.render_frame(args.seed + i, position=pos0 + i * dp, angles=ang0 + i * da)
        path = f"{args.out_prefix}_{i:03d}.png"
        save_png(path, out["bmode"].cpu().numpy())
        print(f"frame {i}: pose {np.round(pos0 + i * dp, 3).tolist()} "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms -> {path}")
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
