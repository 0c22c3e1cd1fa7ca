"""Device timing on one NVIDIA GPU, shared by the scripts that measure the port.

``chip_smoke.py``, ``cluster_timing.py`` and ``fit_step_timing.py`` import
this module; each time or view below is measured one way for all three:

- ``cuda_ms``: mean ms per call over back-to-back calls, by CUDA events;
- ``event_ms``: each call on its own, by CUDA events (a frame, a fit step);
- ``graph_ms``: device ms per kernel launch, replayed from a CUDA graph, so
  without the host's time to launch each that events around a Python call
  include; ``cold_graph_ms`` the same with the 50 MB L2 cache flushed before
  each call, as a caller that runs much else between two calls finds it;
- ``busy_view``: the device's view by ``torch.profiler``: busy time (the
  union of the device events' intervals), device operations and ms by
  kernel name, per call;
- ``grid_sample_remap``: the one PyTorch call that computes the scan
  conversion's function, timed beside its kernel as a yardstick.

Every function but ``nvidia_smi`` needs a CUDA device.
"""

from __future__ import annotations

import subprocess

import torch


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
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


def event_ms(fn, n: int) -> list[float]:
    """ms of each of ``n`` calls of ``fn``, each timed alone by CUDA events."""
    out = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def graph_ms(fn, launches: int, copies: int = 10, reps: int = 10) -> float:
    """Device ms per launch of ``fn`` (``launches`` kernel launches a call)
    replayed from a CUDA graph of ``copies`` calls: the kernels back to
    back, without the host's time to launch each."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(copies):
            fn()
    return cuda_ms(graph.replay, reps) / (copies * launches)


def cold_graph_ms(fn, flush_mb: int = 96) -> float:
    """Device ms of one call of ``fn`` with the L2 cache cold: a graph of
    (overwrite a ``flush_mb`` MB buffer, ``fn``) replayed, less the graph of
    the overwrite alone."""
    buf = torch.empty(flush_mb * 2**20 // 4, device="cuda")
    return graph_ms(lambda: (buf.zero_(), fn()), 1) - graph_ms(buf.zero_, 1)


def busy_view(fn, n: int = 3, attempts: int = 5, expect: dict[str, int] | None = None) -> dict:
    """``n`` calls of ``fn`` under ``torch.profiler``, per call: ``busy_ms``
    (the union of the device events' intervals), ``operations`` (device
    events) and ``by_name`` (ms by kernel name). On an H100 the profiler
    now and then loses device events of a window of small kernels, all of
    them or some: a window is profiled again, ``attempts`` times in all,
    until it holds a device event and, for each name in ``expect``, exactly
    ``n`` times that many events whose name contains it (the launches a
    call makes); else it raises. Only the device is traced: what is read
    here is device events, and tracing the host's operators too made the
    profile of a 28-frame pose step take tens of seconds."""
    from torch.profiler import ProfilerActivity, profile

    expect = expect or {}
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = {k: sum(k in e.name for e in device) for k in expect}
        if device and all(seen[k] == n * v for k, v in expect.items()):
            break
    else:
        raise AssertionError(f"the profiler lost device events: {len(device)} recorded, "
                             f"by name {seen} of {n} x {expect}")
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in device):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_name: dict[str, float] = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    return {"busy_ms": busy / 1e3 / n, "operations": len(device) / n,
            "by_name": {k: v / 1e3 / n for k, v in by_name.items()}}


def grid_sample_remap(map_row: torch.Tensor, map_col: torch.Tensor, rf_rows: int, rf_cols: int):
    """The scan conversion as one ``grid_sample`` call over the polar->Cartesian
    coordinate maps (its coordinate normalisation adds a rounding, so it is a
    yardstick, not a check). Returns a function of the RF image."""
    grid = torch.stack([2.0 * map_col / (rf_cols - 1) - 1.0,
                        2.0 * map_row / (rf_rows - 1) - 1.0], dim=-1)[None]
    return lambda rf: torch.nn.functional.grid_sample(
        rf[None, None], grid, mode="bilinear", padding_mode="zeros", align_corners=True)[0, 0]
