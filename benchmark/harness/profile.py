"""The device's view of a few requests, by ``torch.profiler``.

The arithmetic is the one the port's measuring layer uses (frozen here, so
that a change to the program cannot move it): only the device is traced;
the profiled requests sit between PAD_LAUNCHES one-cycle marker kernels at
each end, which take the events the profiler drops at a window's edges and
are left out of the view; a window that lost events (fewer launches of a
listed kernel than the requests make) is profiled again. Busy time is the
union of the device events' intervals.
"""

from __future__ import annotations

import re
import time

import torch

PAD_LAUNCHES = 128
PAD_NAME = "spin_kernel"
ATTEMPTS = 5


def _pad() -> None:
    for _ in range(PAD_LAUNCHES):
        torch.cuda._sleep(1)


def device_view(run, expect: dict[str, int]) -> dict:
    """Profile ``run()`` (a few requests, synchronised at their end) until
    the window holds ``expect[k]`` events whose name contains ``k``; returns
    ``busy_ms`` (union of the device intervals), ``window_ms`` (host ms of
    ``run``), ``operations``, ``by_name`` (device ms by event name),
    ``count_by_name`` and ``intervals`` ((start us, end us, name), sorted)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _pad()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
            _pad()
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA and PAD_NAME not in e.name]
        seen = {k: sum(k in e.name for e in device) for k in expect}
        if device and all(seen[k] == v for k, v in expect.items()):
            break
    else:
        raise RuntimeError(f"the profiler lost device events: {len(device)} recorded, by name "
                           f"{seen} of {expect}")
    intervals = sorted((e.time_range.start, e.time_range.end, e.name) for e in device)
    by_name: dict[str, float] = {}
    count: dict[str, int] = {}
    for start, stop, name in intervals:
        by_name[name] = by_name.get(name, 0.0) + (stop - start) / 1e3
        count[name] = count.get(name, 0) + 1
    return {"busy_ms": union_ms(intervals), "window_ms": window_ms, "operations": len(device),
            "by_name": by_name, "count_by_name": count, "intervals": intervals}


def union_ms(intervals) -> float:
    """ms covered by the union of sorted (start us, end us, ...) intervals."""
    busy, end = 0.0, float("-inf")
    for start, stop, *_ in intervals:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy / 1e3


_OP = re.compile(r"\w*Functor\w*|\w+_kernel_cuda|\w+_cuda_out|launch_\w+")
_WRAPPERS = {"BinaryFunctor", "AUnaryFunctor", "BUnaryFunctor", "UnaryFunctor"}


def short_name(name: str) -> str:
    """A device event's name without its template and argument lists: the
    kernel, and for PyTorch's generic kernels the operation they apply."""
    name = name.replace("(anonymous namespace)::", "")
    base = re.split(r"[<(]", name.removeprefix("void "), maxsplit=1)[0].strip()
    base = base.rsplit("::", 1)[-1] or name[:60]
    ops = [m for m in _OP.findall(name.partition("<")[2]) if m not in _WRAPPERS]
    return f"{base}[{ops[0]}]" if ops else base


def breakdown(view: dict, top: int = 10) -> dict:
    """The device operations that took most time (seconds in the profiled
    window, by short name) and the longest idle gaps between device
    intervals, each named by the operations on its two sides."""
    by_short: dict[str, float] = {}
    for name, ms in view["by_name"].items():
        by_short[short_name(name)] = by_short.get(short_name(name), 0.0) + ms
    ops = sorted(by_short.items(), key=lambda kv: -kv[1])[:top]
    gaps, end, last = [], None, None
    for start, stop, name in view["intervals"]:
        if end is not None and start > end:
            gaps.append((f"{short_name(last)} -> {short_name(name)}", (start - end) / 1e6))
        if end is None or stop >= end:
            end, last = stop, name
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[name, ms / 1e3] for name, ms in ops],
            "idle_gaps": [[name, s] for name, s in gaps[:top]]}
