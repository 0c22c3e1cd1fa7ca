"""One run of one cell: set-up, the measured window, the traced requests
where asked, then the output check against the reference and the metrics.

Set-up (``setup_s``) runs from the process's start to the first timed
request: the imports, the meshes (written once into the checkout), the
program's scene compile and ``Simulator``, the kernel library (built into
the checkout on a first run), and the entry's warm-up requests, which run
every shape the window uses (for the chained batch: capture its CUDA
graph). The window then runs requests back to back, each finished before
the next, until ``seconds`` have passed; the last request ends it. With
``trace`` the first requests of the window (``traced_requests``) run under
the profiler. The reference runs after the window, once the peak memory is
read and the program is freed. What a cell measures and checks comes from
its entry (``traffic.py``); this module knows no entry.
"""

from __future__ import annotations

import functools
import gc
import os
import time

import numpy as np
import torch

from . import cell, check, meshes, profile, roofline, traffic
from ..reference import frame as ref_frame
from ..reference import imaging as ref_imaging

MESH_ROOT = os.path.join(cell.ROOT, "build", "benchmark", "meshes")


def simulator(conf: dict, acquisition: dict, scene_path: str, mesh_dir: str, texture_seed: int,
              device):
    """The program under test: the port's ``Simulator`` of the configuration.
    Its ``closest_hit`` is ``"bvh"`` (K11's walk) or a cluster mode."""
    from mcray_tpu_torch.config import SimConfig
    from mcray_tpu_torch.models.simulator import Simulator
    from mcray_tpu_torch.scene.compile import load_and_compile

    pack = load_and_compile(scene_path, asset_dir=mesh_dir)
    hit = conf["closest_hit"]
    choice = {"use_bvh": True} if hit == "bvh" else {"intersect_mode": hit}
    return Simulator(pack, SimConfig(**acquisition), device=device, seed=texture_seed, **choice)


class Context:
    """What an entry builds its workload from, all drawn from the run's seed:
    the configuration ``conf`` and its ``acquisition``, the scene, the seed's
    ``streams`` (``scene``, ``requests``, ``sample``), the texture seed, the
    device, the answers' ``guard``, the program (``simulator()``) and the
    plain ``reference`` (built on first use, after the window)."""

    def __init__(self, conf: dict, acquisition: dict, seed: int, device):
        self.conf, self.acq, self.device = conf, acquisition, device
        seq = np.random.SeedSequence(int(seed) % 2**64)
        self.streams = dict(zip(("scene", "requests", "sample"),
                                (np.random.default_rng(s) for s in seq.spawn(3))))
        self.texture_seed = traffic.seed_words(self.streams["scene"])
        self.mesh_dir = meshes.ensure(conf["meshes"], os.path.join(MESH_ROOT, conf["name"]))
        self.scene_path = os.path.join(cell.ROOT, conf["scene"])
        self.guard = traffic.Guard(ref_imaging.fan_outside(ref_imaging.scan_table(acquisition,
                                                                                  device)))

    def simulator(self):
        return simulator(self.conf, self.acq, self.scene_path, self.mesh_dir, self.texture_seed,
                         self.device)

    @functools.cached_property
    def reference(self) -> ref_frame.Reference:
        return ref_frame.Reference(self.acq, self.scene_path, self.mesh_dir, self.texture_seed,
                                   self.device)


class Trace:
    """What the per-layer readers read: the profiled requests' device view,
    their units (frames), and the frame's floor (counted on demand on the
    reference's trace of the checked frames)."""

    def __init__(self, view: dict, frames: int, floor):
        self.view, self.frames = view, frames
        self.kernel_names = set(roofline.EVENT_NAMES.values())
        self._floor = floor

    @functools.cached_property
    def floor_ms_per_frame(self) -> float | None:
        return self._floor()

    def kernel_ms(self, *names: str) -> float:
        return sum(ms for name, ms in self.view["by_name"].items()
                   if any(n in name for n in names))


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, t_start: float,
             device="cuda", chips: int = 1, acquisition: dict | None = None,
             mix: dict | None = None) -> dict:
    """The result of one run of ``name``: ``result`` (the line's object) and
    ``stderr`` (the check's lines). ``acquisition`` and ``mix`` override
    fields of the configuration and of the traffic (the tests' small frames
    on the CPU)."""
    spec = cell.benchmark()
    w = cell.workload(spec, name)
    conf, limits = cell.config(w["config"]), cell.limits(name)
    mix = {**cell.traffic(w["traffic"]), **(mix or {})}
    ctx = Context(conf, {**conf["acquisition"], **(acquisition or {})}, seed, device)
    on_card = torch.device(device).type == "cuda"

    wl = traffic.make(mix, ctx)
    wl.warm()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    ends = []

    def one():
        wl.request()
        ends.append(time.perf_counter())

    t_window = time.perf_counter()
    view = None
    if trace:
        n = mix["traced_requests"]
        view = profile.device_view(lambda: [one() for _ in range(n)],
                                   {k: v * n for k, v in wl.expect().items()})
    while time.perf_counter() - t_window < seconds:
        one()
    units = len(ends) * wl.units
    measured = {**wl.measured(units, ends[-1] - t_window), "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    bad = int(ctx.guard.bad)

    wl.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    pairs = wl.compare()
    gaps = [g for program, ref in pairs for g in check.rel_l2(program, ref["bmode"])]
    verdict = check.verdict(gaps, bad, limits, wl.expected())

    if trace:
        def floor():
            s = ctx.reference.scene
            tree = roofline.Tree(s.bvh_nodes, s.bvh_meta, s.bvh_order, s.tris, device)
            return roofline.frame_floor_ms(pairs[0][1]["segments"], tree, ctx.acq)

        tr = Trace(view, mix["traced_requests"] * wl.units, floor)
        metrics = {}
        for m in cell.per_layer(spec, name):
            value = cell.reader(m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end(spec, name)}

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = view["busy_ms"] / 1e3
        dev["window_s"] = view["window_ms"] / 1e3
    result = {"correct": verdict["correct"], "attempted": units, "failed": bad,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = profile.breakdown(view)
    result["check"] = verdict["numbers"]
    return {"result": result, "stderr": check.lines(verdict["numbers"])}
