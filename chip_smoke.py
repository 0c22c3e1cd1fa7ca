#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mcray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the four CUDA kernels from mcray_tpu_torch/csrc, renders the
full-size sphere frame (SimConfig(): 512 elements x 5 paths x 10 bounces,
465 x 512 RF, 400 x 500 B-mode) through them, holds every kernel against
its plain PyTorch version at the shapes the frame gave it, checks the
launch counts and the image, answers a few requests, and times the frame,
its stages and each kernel beside its plain version with CUDA events.

The second-to-last lines are the kernel record ({"kernels": [...]}) and the
card's `nvidia-smi` name and power limit; the last line is
{"ok": true, "device": {...}}. Any failed phase raises (exit code != 0,
no result line). Without a CUDA device it fails at once.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SPHERE_SCENE = os.path.join(REPO, "assets", "sphere", "sphere.scene")
TIMED_FRAMES = 25
TOLERANCES = {  # (rtol, atol) of kernel vs plain at the frame's shapes
    "march": (1e-4, 1e-5),
    "postproc": (1e-5, 1e-6),
    "scanconv": (1e-6, 1e-6),
}


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, by CUDA events, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    rtol, atol = TOLERANCES[name]
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: kernel != plain (max abs err {err}, rtol {rtol}, atol {atol})")
    print(f"  {name}: max abs err {err:.3e} (rtol {rtol}, atol {atol}) ok")
    return err


def main() -> int:
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU")
    smi = nvidia_smi()
    print(f"gpu: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from mcray_tpu_torch.config import SimConfig, small_test_config
    from mcray_tpu_torch.models import simulator
    from mcray_tpu_torch.models.simulator import Simulator
    from mcray_tpu_torch.ops import cuda as kernels
    from mcray_tpu_torch.ops.cuda import _build, intersect, march, postproc, scanconv
    from mcray_tpu_torch.scene.compile import load_and_compile

    # 1. build
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s -> {_build.library_path()}")
    for line in _build.build_log().splitlines():
        if "registers" in line or "Compiling entry" in line or line.startswith("# "):
            print(f"  {line.strip()}")

    # 2. the main path: one full-size frame through the user's entry point
    cfg = SimConfig()
    pack = load_and_compile(SPHERE_SCENE)
    sim = Simulator(pack, cfg, device="cuda", seed=0)
    print(f"[frame] sphere: {pack.n_triangles} triangles; {cfg.transducer_elements} elements x "
          f"{cfg.samples_per_element} paths x {cfg.max_depth} bounces")
    kernels.reset_launch_counts()
    out = sim.render_frame(seed=0)
    torch.cuda.synchronize()
    frame_launches = kernels.launch_counts()
    print(f"  launches: {frame_launches}")
    expected = {"intersect": cfg.max_depth, "march": 1, "postproc": 1, "scanconv": 1}
    if frame_launches != expected:
        raise AssertionError(f"launch counts {frame_launches} != {expected}")

    bmode = out["bmode"]
    table = sim.scan_table[:, :, : cfg.bmode_cols]
    outside = ((table[:, 1] == 0) & (table[:, 2] == 0)) | ((table[:, 4] == 0) & (table[:, 5] == 0))
    if tuple(bmode.shape) != (cfg.bmode_rows, cfg.bmode_cols):
        raise AssertionError(f"bmode shape {tuple(bmode.shape)}")
    if not bool(torch.isfinite(bmode).all()) or float(bmode.min()) < 0.0:
        raise AssertionError("bmode is not finite and non-negative")
    if float(bmode[outside].abs().max()) != 0.0:
        raise AssertionError("bmode is not zero outside the fan")
    fan_std = float(bmode[~outside].std())
    if not fan_std > 0.0:
        raise AssertionError("bmode has no texture inside the fan")
    print(f"  bmode {tuple(bmode.shape)}: min {float(bmode.min()):.4g} max {float(bmode.max()):.4g} "
          f"fan std {fan_std:.4g}; {int(outside.sum())} pixels outside the fan are 0")

    # 3. every kernel against its plain version at the frame's own inputs
    print("[kernels vs plain]")
    rays = out["segments"]["rays"]
    tri_soa = sim.scene["tri_soa"]
    differing, t_err = 0, 0.0
    for d in range(cfg.max_depth):
        q = rays[d].contiguous()
        t_k, i_k = intersect.intersect_best(q, tri_soa)
        t_p, i_p = intersect.intersect_best_plain(q, tri_soa)
        differing += int(((t_k < 1.5) != (t_p < 1.5)).sum() + (i_k != i_p).sum())
        t_err = max(t_err, float((t_k - t_p).abs().max()))
    print(f"  intersect: {differing} differing rays over {cfg.max_depth} bounces, "
          f"max |t| err {t_err:.3e}")
    if differing or t_err:
        raise AssertionError("intersect kernel != plain")
    soa, rf_raw, rf_env = out["soa"], out["rf_raw"], out["rf_env"]
    errs = {"intersect": t_err}
    errs["march"] = check_close("march", march.march_cuda(soa, sim.seeds, cfg, cfg.rf_cols),
                                march.march_plain(soa, sim.seeds, cfg, cfg.rf_cols))
    errs["postproc"] = check_close("postproc", postproc.postproc_cuda(rf_raw, cfg),
                                   postproc.postproc_plain(rf_raw, cfg))
    errs["scanconv"] = check_close(
        "scanconv", scanconv.scan_convert_cuda(rf_env, sim.scan_table, cfg.bmode_cols),
        scanconv.scan_convert_plain(rf_env, sim.scan_table, cfg.bmode_cols))

    # 4. the whole CUDA path against the whole plain CPU path, same randomness
    small = small_test_config()
    gpu_sim = Simulator(pack, small, device="cuda", seed=5)
    cpu_sim = Simulator(pack, small, device="cpu", seed=5)
    draws = cpu_sim.draws(5)
    args = (gpu_sim.seeds, gpu_sim.materials, gpu_sim.position, gpu_sim.angles)
    on_gpu = simulator.render({k: v.cuda() for k, v in draws.items()}, *args, gpu_sim.scene,
                              gpu_sim.spacing, gpu_sim.starting_material, gpu_sim.scan_table, small)
    on_cpu = simulator.render(
        draws, cpu_sim.seeds, cpu_sim.materials, cpu_sim.position, cpu_sim.angles, cpu_sim.scene,
        cpu_sim.spacing, cpu_sim.starting_material, cpu_sim.scan_table, small)
    valid_equal = torch.equal(on_gpu["segments"]["valid"].cpu(), on_cpu["segments"]["valid"])
    rf_err = float((on_gpu["rf_raw"].cpu() - on_cpu["rf_raw"]).abs().max())
    bm_err = float((on_gpu["bmode"].cpu() - on_cpu["bmode"]).abs().max())
    print(f"[cuda path vs cpu path] small config: segments valid equal {valid_equal}, "
          f"rf_raw max err {rf_err:.3e}, bmode max err {bm_err:.3e}")
    if not (valid_equal
            and torch.allclose(on_gpu["rf_raw"].cpu(), on_cpu["rf_raw"], rtol=1e-4, atol=1e-5)
            and torch.allclose(on_gpu["bmode"].cpu(), on_cpu["bmode"], rtol=1e-4, atol=1e-5)):
        raise AssertionError("the CUDA path disagrees with the plain CPU path")

    # 5. a few requests: three probe poses x two seeds, and one compound of four seeds
    kernels.reset_launch_counts()
    pos0, ang0 = sim.position.cpu(), sim.angles.cpu()
    poses = [(pos0, ang0), (pos0 + torch.tensor([0.3, 0.0, 0.0]), ang0),
             (pos0, ang0 + torch.tensor([0.0, 0.0, 4.0]))]
    for i, (pos, ang) in enumerate(poses):
        for seed in (11, 12):
            b = sim.render_frame(seed, position=pos, angles=ang)["bmode"]
            if not bool(torch.isfinite(b).all()) or not float(b.std()) > 0:
                raise AssertionError(f"request pose {i} seed {seed}: bad frame")
    compound = sim.render_compound([21, 22, 23, 24])
    torch.cuda.synchronize()
    if tuple(compound.shape) != (cfg.bmode_rows, cfg.bmode_cols) or not bool(
            torch.isfinite(compound).all()):
        raise AssertionError("bad compound frame")
    served = kernels.launch_counts()
    frames = len(poses) * 2 + 4
    want = {"intersect": cfg.max_depth * frames, "march": frames, "postproc": frames,
            "scanconv": frames}
    print(f"[requests] {len(poses) * 2} frames + compound of 4: launches {served}")
    if served != want:
        raise AssertionError(f"request launch counts {served} != {want}")

    # 6. timing (CUDA events, after the warm-up above)
    print(f"[timing] {smi}")
    frame_ms = []
    for i in range(TIMED_FRAMES):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        sim.render_frame(seed=100 + i)
        end.record()
        end.synchronize()
        frame_ms.append(start.elapsed_time(end))
    med = statistics.median(frame_ms)
    print(f"  frame: median {med:.3f} ms over {TIMED_FRAMES} frames "
          f"(min {min(frame_ms):.3f}, max {max(frame_ms):.3f}); "
          f"{sim.rays_per_frame / med * 1e3:,.0f} rays/s ({sim.rays_per_frame} rays/frame)")

    draws = sim.draws(0)
    trace_args = (draws, sim.materials, sim.position, sim.angles, sim.scene, sim.spacing,
                  sim.starting_material, cfg)
    stage_ms = {
        "trace": cuda_ms(lambda: simulator.trace_paths(*trace_args), 5),
        "march": cuda_ms(lambda: march.march_cuda(
            march.pack_segments(out["segments"], sim.materials, cfg, cfg.rf_cols),
            sim.seeds, cfg, cfg.rf_cols), 10),
        "postproc": cuda_ms(lambda: postproc.postproc_cuda(rf_raw, cfg), 20),
        "scanconv": cuda_ms(lambda: scanconv.scan_convert_cuda(rf_env, sim.scan_table,
                                                               cfg.bmode_cols), 20),
    }
    print("  stages (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
          + " (march includes pack_segments)")

    bounce_rays = [rays[d].contiguous() for d in range(cfg.max_depth)]
    timed = {
        "intersect": (lambda: [intersect.intersect_best(q, tri_soa) for q in bounce_rays],
                      lambda: [intersect.intersect_best_plain(q, tri_soa) for q in bounce_rays],
                      cfg.max_depth),
        "march": (lambda: march.march_cuda(soa, sim.seeds, cfg, cfg.rf_cols),
                  lambda: march.march_plain(soa, sim.seeds, cfg, cfg.rf_cols), 1),
        "postproc": (lambda: postproc.postproc_cuda(rf_raw, cfg),
                     lambda: postproc.postproc_plain(rf_raw, cfg), 1),
        "scanconv": (lambda: scanconv.scan_convert_cuda(rf_env, sim.scan_table, cfg.bmode_cols),
                     lambda: scanconv.scan_convert_plain(rf_env, sim.scan_table, cfg.bmode_cols), 1),
    }
    sources = {
        "intersect": ("mcray_tpu_torch/csrc/intersect.cu",
                      "mcray_tpu/ops/pallas/intersect.py:41"),
        "march": ("mcray_tpu_torch/csrc/march.cu", "mcray_tpu/ops/pallas/march.py:233"),
        "postproc": ("mcray_tpu_torch/csrc/postproc.cu", "mcray_tpu/ops/pallas/postproc.py:26"),
        "scanconv": ("mcray_tpu_torch/csrc/scanconv.cu", "mcray_tpu/ops/pallas/scanconv.py:447"),
    }
    record = []
    for name, (kernel_fn, plain_fn, per_call) in timed.items():
        # kernel, plain, plain, kernel: both see the same card state
        k1 = cuda_ms(kernel_fn, 10)
        p1 = cuda_ms(plain_fn, 3)
        p2 = cuda_ms(plain_fn, 3)
        k2 = cuda_ms(kernel_fn, 10)
        k_ms, p_ms = (k1 + k2) / 2 / per_call, (p1 + p2) / 2 / per_call
        print(f"  {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms per launch "
              f"({p_ms / k_ms:.1f}x)")
        src, replaces = sources[name]
        record.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": frame_launches[name], "max_abs_err": errs[name],
            "ms": k_ms, "plain_ms": p_ms,
        })

    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
