#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mcray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the seven CUDA kernels from mcray_tpu_torch/csrc (one nvcc per
source, all at once) and drives the port's paths at SimConfig() (512
elements x 5 paths x 10 bounces, 465 x 512 RF, 400 x 500 B-mode), each
with the launch counts set to 0 just before it and read just after:

- the sphere (2,220 triangles) on its default kernel set: listed
  intersect (K5), march (K2), postproc (K3), scan conversion (K4), plus a
  few requests (poses, seeds, a compound);
- the sphere on the brute closest hit (K1);
- the 123,224-triangle ircad_hd scene on its default (listed) set;
- the culled (K6) and staged (K7) closest hits on both scenes.

Every kernel is held against its plain PyTorch version at the shapes its
path gave it (closest hits bitwise in t and slot, at every bounce; the
cluster kernels' hit and t also against K1's bitwise), the CUDA path
against the plain CPU path on a small config, and every frame's image is
checked. Frames, stages and kernels (beside their plain versions) are
timed with CUDA events.

The last lines are the kernel record ({"kernels": [...]}), the card's
`nvidia-smi` name and power limit, and {"ok": true, "device": {...}}. Any
failed phase raises (exit code != 0, no result line). Without a CUDA
device it fails at once.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

from mcray_tpu_torch.config import SimConfig, small_test_config
from mcray_tpu_torch.models import simulator
from mcray_tpu_torch.models.simulator import CLUSTER_INTERSECTS, Simulator
from mcray_tpu_torch.ops import clusters
from mcray_tpu_torch.ops import cuda as kernels
from mcray_tpu_torch.ops.cuda import (_build, intersect, intersect_culled, intersect_listed,
                                      intersect_staged, march, postproc, scanconv)
from mcray_tpu_torch.ops.geometry import NO_HIT_T
from mcray_tpu_torch.scene.compile import load_and_compile

REPO = os.path.dirname(os.path.abspath(__file__))
SPHERE_SCENE = os.path.join(REPO, "assets", "sphere", "sphere.scene")
IRCAD_HD_SCENE = os.path.join(REPO, "assets", "ircad11_hd", "santi-liver-hd.scene")
# the ircad_hd phantom meshes are generated here (git ignores build/)
IRCAD_HD_ASSETS = os.path.join(REPO, "build", "mcray_tpu_torch", "ircad11_hd")
TIMED_FRAMES = {"sphere": 25, "sphere brute": 5, "ircad_hd": 10}
TOLERANCES = {  # (rtol, atol) of kernel vs plain at the frame's shapes
    "march": (1e-4, 1e-5),
    "postproc": (1e-5, 1e-6),
    "scanconv": (1e-6, 1e-6),
}
SOURCES = {  # kernel: (source, TPU kernel it replaces)
    "intersect": ("mcray_tpu_torch/csrc/intersect.cu", "mcray_tpu/ops/pallas/intersect.py:41"),
    "intersect_listed": ("mcray_tpu_torch/csrc/intersect_listed.cu",
                         "mcray_tpu/ops/pallas/intersect.py:859"),
    "intersect_culled": ("mcray_tpu_torch/csrc/intersect_culled.cu",
                         "mcray_tpu/ops/pallas/intersect.py:1461"),
    "intersect_staged": ("mcray_tpu_torch/csrc/intersect_staged.cu",
                         "mcray_tpu/ops/pallas/intersect.py:460"),
    "march": ("mcray_tpu_torch/csrc/march.cu", "mcray_tpu/ops/pallas/march.py:233"),
    "postproc": ("mcray_tpu_torch/csrc/postproc.cu", "mcray_tpu/ops/pallas/postproc.py:26"),
    "scanconv": ("mcray_tpu_torch/csrc/scanconv.cu", "mcray_tpu/ops/pallas/scanconv.py:447"),
}
CLUSTER_KERNEL = {"listed": "intersect_listed", "culled": "intersect_culled",
                  "staged": "intersect_staged"}


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


def paired_ms(kernel_fn, plain_fn, per_call: int, k_reps: int = 10, p_reps: int = 3):
    """(kernel, plain) ms per launch, timed kernel, plain, plain, kernel."""
    k1 = cuda_ms(kernel_fn, k_reps)
    p1 = cuda_ms(plain_fn, p_reps)
    p2 = cuda_ms(plain_fn, p_reps)
    k2 = cuda_ms(kernel_fn, k_reps)
    return (k1 + k2) / 2 / per_call, (p1 + p2) / 2 / per_call


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    rtol, atol = TOLERANCES[name]
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: kernel != plain (max abs err {err}, rtol {rtol}, atol {atol})")
    print(f"  {name}: max abs err {err:.3e} (rtol {rtol}, atol {atol}) ok")
    return err


def check_bmode(name: str, sim, bmode: torch.Tensor) -> None:
    """Finite, non-negative B-mode of the right shape: zero outside the fan,
    texture inside."""
    cfg = sim.cfg
    table = sim.scan_table[:, :, : cfg.bmode_cols]
    outside = ((table[:, 1] == 0) & (table[:, 2] == 0)) | ((table[:, 4] == 0) & (table[:, 5] == 0))
    if tuple(bmode.shape) != (cfg.bmode_rows, cfg.bmode_cols):
        raise AssertionError(f"{name}: bmode shape {tuple(bmode.shape)}")
    if not bool(torch.isfinite(bmode).all()) or float(bmode.min()) < 0.0:
        raise AssertionError(f"{name}: bmode is not finite and non-negative")
    if float(bmode[outside].abs().max()) != 0.0:
        raise AssertionError(f"{name}: bmode is not zero outside the fan")
    fan_std = float(bmode[~outside].std())
    if not fan_std > 0.0:
        raise AssertionError(f"{name}: bmode has no texture inside the fan")
    print(f"  bmode {tuple(bmode.shape)}: min {float(bmode.min()):.4g} max {float(bmode.max()):.4g} "
          f"fan std {fan_std:.4g}; {int(outside.sum())} pixels outside the fan are 0")


def drive(name: str, sim, expected: dict[str, int], seed: int = 0):
    """One frame through ``sim`` with the launch counts set to 0 just
    before and read just after; every count must be as ``expected`` (0 for
    the kernels not named)."""
    print(f"[path] {name}: {sim.pack.n_triangles} triangles, intersect "
          f"{sim.culled_tris[1] if sim.culled_tris else 'brute'}, tile_r {sim.intersect_tile_r}")
    kernels.reset_launch_counts()
    out = sim.render_frame(seed=seed)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"  launches: {counts}")
    want = {k: expected.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{name}: launch counts {counts} != {want}")
    check_bmode(name, sim, out["bmode"])
    return out, counts


def check_cluster_bounces(name: str, sim, rays: torch.Tensor, tri_soa) -> list:
    """The path's cluster kernel against its plain version (t and slot
    bitwise) and the cluster path's hit and t against K1's (bitwise), at
    every bounce's rays of the frame; returns the per-bounce (kernel,
    plain, arguments)."""
    packed, mode = sim.culled_tris
    tile_r = sim.intersect_tile_r
    calls = []
    differing = vs_brute = 0
    for d in range(rays.shape[0]):
        o, s = rays[d][0:3].T.contiguous(), rays[d][3:6].T.contiguous()
        op, sp, padded = clusters.pad_rays(o, s, tile_r)
        if mode == "listed":
            live = torch.abs(sp).sum(dim=1) > 0.0
            args = (padded, *clusters.packet_cluster_lists(op, sp, packed, tile_r),
                    torch.where(live, NO_HIT_T, 0.0), torch.zeros_like(live, dtype=torch.int32),
                    packed)
            kernel, plain = intersect_listed.listed_best, intersect_listed.listed_best_plain
        else:
            mod = intersect_culled if mode == "culled" else intersect_staged
            args = (padded, packed, tile_r)
            kernel, plain = getattr(mod, f"{mode}_best"), getattr(mod, f"{mode}_best_plain")
        t_k, i_k = kernel(*args)
        t_p, i_p = plain(*args)
        differing += int((t_k != t_p).sum() + (i_k != i_p).sum())
        got = CLUSTER_INTERSECTS[mode](o, s, packed, tile_r=tile_r)
        bt, _ = intersect.intersect_best(rays[d].contiguous(), tri_soa)
        vs_brute += int((got["hit"] != (bt < 1.5)).sum() + (got["t"] != bt).sum())
        calls.append((kernel, plain, args))
    print(f"  {CLUSTER_KERNEL[mode]} ({name}): {differing} differing (t, slot) vs plain, "
          f"{vs_brute} differing (hit, t) vs K1 brute, over {rays.shape[0]} bounces")
    if differing or vs_brute:
        raise AssertionError(f"{name}: {CLUSTER_KERNEL[mode]} disagrees")
    return calls


def time_frames(name: str, sim, n: int) -> float:
    frame_ms = []
    for i in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        sim.render_frame(seed=100 + i)
        end.record()
        end.synchronize()
        frame_ms.append(start.elapsed_time(end))
    med = statistics.median(frame_ms)
    print(f"  {name} frame: median {med:.3f} ms over {n} frames (min {min(frame_ms):.3f}, "
          f"max {max(frame_ms):.3f}); {sim.rays_per_frame / med * 1e3:,.0f} rays/s "
          f"({sim.rays_per_frame} rays/frame)")
    return med


def time_stages(name: str, sim, out) -> dict[str, float]:
    cfg = sim.cfg
    draws = sim.draws(0)
    args = (draws, sim.materials, sim.position, sim.angles, sim.scene, sim.spacing,
            sim.starting_material, cfg)
    stage_ms = {
        "trace": cuda_ms(lambda: simulator.trace_paths(*args, **sim.trace_kw), 5),
        "march": cuda_ms(lambda: march.march_cuda(
            march.pack_segments(out["segments"], sim.materials, cfg, cfg.rf_cols),
            sim.seeds, cfg, cfg.rf_cols), 10),
        "postproc": cuda_ms(lambda: postproc.postproc_cuda(out["rf_raw"], cfg), 20),
        "scanconv": cuda_ms(lambda: scanconv.scan_convert_cuda(out["rf_env"], sim.scan_table,
                                                               cfg.bmode_cols), 20),
    }
    print(f"  {name} stages (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
          + " (march includes pack_segments)")
    return stage_ms


def main() -> int:
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU")
    smi = nvidia_smi()
    print(f"gpu: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. build
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s -> {_build.library_path()}")
    for line in _build.build_log().splitlines():
        if "registers" in line or line.startswith("# ") and " -c " not in line:
            print(f"  {line.strip()}")

    cfg = SimConfig()
    loop = {"march": 1, "postproc": 1, "scanconv": 1}
    t0 = time.perf_counter()
    sphere = load_and_compile(SPHERE_SCENE)
    ircad = load_and_compile(IRCAD_HD_SCENE, asset_dir=IRCAD_HD_ASSETS)
    print(f"[scenes] sphere {sphere.n_triangles}, ircad_hd {ircad.n_triangles} triangles "
          f"(assets + BVH {time.perf_counter() - t0:.1f} s); {cfg.transducer_elements} elements x "
          f"{cfg.samples_per_element} paths x {cfg.max_depth} bounces")
    if ircad.n_triangles != 123_224:
        raise AssertionError(f"ircad_hd has {ircad.n_triangles} triangles")

    # 2. the paths, each driven with the counts set to 0 just before it
    sims = {
        "sphere": Simulator(sphere, cfg, device="cuda", seed=0),
        "sphere brute": Simulator(sphere, cfg, device="cuda", seed=0, use_culled_intersect=False),
        "ircad_hd": Simulator(ircad, cfg, device="cuda", seed=0),
        "sphere culled": Simulator(sphere, cfg, device="cuda", seed=0, intersect_mode="culled"),
        "ircad_hd culled": Simulator(ircad, cfg, device="cuda", seed=0, intersect_mode="culled"),
        "sphere staged": Simulator(sphere, cfg, device="cuda", seed=0, intersect_mode="staged"),
        "ircad_hd staged": Simulator(ircad, cfg, device="cuda", seed=0, intersect_mode="staged"),
    }
    expected = {
        "sphere": {"intersect_listed": cfg.max_depth, **loop},
        "sphere brute": {"intersect": cfg.max_depth, **loop},
        "ircad_hd": {"intersect_listed": cfg.max_depth, **loop},
        "sphere culled": {"intersect_culled": cfg.max_depth, **loop},
        "ircad_hd culled": {"intersect_culled": cfg.max_depth, **loop},
        "sphere staged": {"intersect_staged": cfg.max_depth, **loop},
        "ircad_hd staged": {"intersect_staged": cfg.max_depth, **loop},
    }
    outs, counts = {}, {}
    for name, sim in sims.items():
        outs[name], counts[name] = drive(name, sim, expected[name])

    # a few requests on the sphere's default set: three poses x two seeds, a compound of four
    sim = sims["sphere"]
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
    want = {k: 0 for k in served} | {"intersect_listed": cfg.max_depth * frames, "march": frames,
                                     "postproc": frames, "scanconv": frames}
    print(f"[requests] sphere: {len(poses) * 2} frames + compound of 4: launches {served}")
    if served != want:
        raise AssertionError(f"request launch counts {served} != {want}")

    # 3. every kernel against its plain version at its path's own inputs
    print("[kernels vs plain]")
    brute_rays = outs["sphere brute"]["segments"]["rays"]
    tri_soa = {"sphere": sims["sphere brute"].scene["tri_soa"],
               "ircad_hd": sims["ircad_hd"].scene["tri_soa"]}
    differing, t_err = 0, 0.0
    for d in range(cfg.max_depth):
        q = brute_rays[d].contiguous()
        t_k, i_k = intersect.intersect_best(q, tri_soa["sphere"])
        t_p, i_p = intersect.intersect_best_plain(q, tri_soa["sphere"])
        differing += int(((t_k < 1.5) != (t_p < 1.5)).sum() + (i_k != i_p).sum())
        t_err = max(t_err, float((t_k - t_p).abs().max()))
    print(f"  intersect (sphere brute): {differing} differing rays over {cfg.max_depth} bounces, "
          f"max |t| err {t_err:.3e}")
    if differing or t_err:
        raise AssertionError("intersect kernel != plain")
    errs = {"intersect": t_err}
    cluster_calls = {}
    for name in ("sphere", "ircad_hd", "sphere culled", "ircad_hd culled", "sphere staged",
                 "ircad_hd staged"):
        scene = name.split()[0]
        cluster_calls[name] = check_cluster_bounces(
            name, sims[name], outs[name]["segments"]["rays"], tri_soa[scene])
        errs[CLUSTER_KERNEL[sims[name].culled_tris[1]]] = 0.0
    out = outs["sphere"]
    soa, rf_raw, rf_env = out["soa"], out["rf_raw"], out["rf_env"]
    errs["march"] = check_close("march", march.march_cuda(soa, sim.seeds, cfg, cfg.rf_cols),
                                march.march_plain(soa, sim.seeds, cfg, cfg.rf_cols))
    errs["postproc"] = check_close("postproc", postproc.postproc_cuda(rf_raw, cfg),
                                   postproc.postproc_plain(rf_raw, cfg))
    errs["scanconv"] = check_close(
        "scanconv", scanconv.scan_convert_cuda(rf_env, sim.scan_table, cfg.bmode_cols),
        scanconv.scan_convert_plain(rf_env, sim.scan_table, cfg.bmode_cols))

    # 4. the whole CUDA path against the whole plain CPU path, same randomness
    small = small_test_config()
    gpu_sim = Simulator(sphere, small, device="cuda", seed=5)
    cpu_sim = Simulator(sphere, small, device="cpu", seed=5)
    draws = cpu_sim.draws(5)
    on_gpu = simulator.render(
        {k: v.cuda() for k, v in draws.items()}, gpu_sim.seeds, gpu_sim.materials,
        gpu_sim.position, gpu_sim.angles, gpu_sim.scene, gpu_sim.spacing,
        gpu_sim.starting_material, gpu_sim.scan_table, small, **gpu_sim.trace_kw)
    on_cpu = simulator.render(
        draws, cpu_sim.seeds, cpu_sim.materials, cpu_sim.position, cpu_sim.angles, cpu_sim.scene,
        cpu_sim.spacing, cpu_sim.starting_material, cpu_sim.scan_table, small, **cpu_sim.trace_kw)
    valid_equal = torch.equal(on_gpu["segments"]["valid"].cpu(), on_cpu["segments"]["valid"])
    rf_err = float((on_gpu["rf_raw"].cpu() - on_cpu["rf_raw"]).abs().max())
    bm_err = float((on_gpu["bmode"].cpu() - on_cpu["bmode"]).abs().max())
    print(f"[cuda path vs cpu path] small config, listed: segments valid equal {valid_equal}, "
          f"rf_raw max err {rf_err:.3e}, bmode max err {bm_err:.3e}")
    if not (valid_equal
            and torch.allclose(on_gpu["rf_raw"].cpu(), on_cpu["rf_raw"], rtol=1e-4, atol=1e-5)
            and torch.allclose(on_gpu["bmode"].cpu(), on_cpu["bmode"], rtol=1e-4, atol=1e-5)):
        raise AssertionError("the CUDA path disagrees with the plain CPU path")

    # 5. timing (CUDA events, after the warm-up above)
    print(f"[timing] {smi}")
    for name, n in TIMED_FRAMES.items():
        time_frames(name, sims[name], n)
    for name in ("sphere", "ircad_hd"):
        time_stages(name, sims[name], outs[name])

    timed = {"sphere": {}, "ircad_hd": {}}
    for scene in ("sphere", "ircad_hd"):
        src = brute_rays if scene == "sphere" else outs["ircad_hd"]["segments"]["rays"]
        bounce_rays = [src[d].contiguous() for d in range(cfg.max_depth)]
        soa_t = tri_soa[scene]
        # K1's plain version at 123k triangles is not timed: its (rays x
        # triangles) chunks are the wrong algorithm at that size
        plain_k1 = (lambda q=bounce_rays, s=soa_t: [intersect.intersect_best_plain(r, s) for r in q])
        timed[scene]["intersect"] = (
            lambda q=bounce_rays, s=soa_t: [intersect.intersect_best(r, s) for r in q],
            plain_k1 if scene == "sphere" else None)
        for name in (scene, f"{scene} culled", f"{scene} staged"):
            calls = cluster_calls[name]
            timed[scene][CLUSTER_KERNEL[sims[name].culled_tris[1]]] = (
                lambda c=calls: [k(*a) for k, _, a in c], lambda c=calls: [p(*a) for _, p, a in c])
    timed["sphere"].update({
        "march": (lambda: march.march_cuda(soa, sim.seeds, cfg, cfg.rf_cols),
                  lambda: march.march_plain(soa, sim.seeds, cfg, cfg.rf_cols)),
        "postproc": (lambda: postproc.postproc_cuda(rf_raw, cfg),
                     lambda: postproc.postproc_plain(rf_raw, cfg)),
        "scanconv": (lambda: scanconv.scan_convert_cuda(rf_env, sim.scan_table, cfg.bmode_cols),
                     lambda: scanconv.scan_convert_plain(rf_env, sim.scan_table, cfg.bmode_cols)),
    })
    per_call = {k: cfg.max_depth for k in CLUSTER_KERNEL.values()} | {"intersect": cfg.max_depth}
    ms = {"sphere": {}, "ircad_hd": {}}
    for scene, fns in timed.items():
        for name, (kernel_fn, plain_fn) in fns.items():
            n = per_call.get(name, 1)
            if plain_fn is None:
                ms[scene][name] = (cuda_ms(kernel_fn, 3) / n, None)
            else:
                ms[scene][name] = paired_ms(kernel_fn, plain_fn, n,
                                            p_reps=1 if scene == "ircad_hd" else 3)
            k_ms, p_ms = ms[scene][name]
            plain = f"plain {p_ms:.4f} ms ({p_ms / k_ms:.1f}x)" if p_ms else "plain not timed"
            print(f"  {scene} {name}: kernel {k_ms:.4f} ms, {plain} per launch")

    path_of = {"intersect": "sphere brute", "intersect_listed": "sphere",
               "intersect_culled": "sphere culled", "intersect_staged": "sphere staged",
               "march": "sphere", "postproc": "sphere", "scanconv": "sphere"}
    record = []
    for name, (src, replaces) in SOURCES.items():
        k_ms, p_ms = ms["sphere"][name]
        entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": counts[path_of[name]][name], "max_abs_err": errs[name],
                 "ms": k_ms, "plain_ms": p_ms}
        if name in ms["ircad_hd"]:
            entry["ircad_hd_ms"], entry["ircad_hd_plain_ms"] = ms["ircad_hd"][name]
        record.append(entry)

    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
