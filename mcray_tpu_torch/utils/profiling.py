"""Per-stage timing and frame metrics.

Port of ``mcray_tpu/utils/profiling.py``: a registry of wall-clock stage
timers and counters with rays/s accounting (``FrameMetrics``, the same
summary keys), and ``device_trace``, a ``torch.profiler`` trace written as
a Chrome trace (the reference captures a ``jax.profiler`` trace).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


def _synchronize(tree) -> None:
    """Wait for the devices of the CUDA tensors in ``tree`` (a tensor, or a
    dict, list or tuple of them); CPU tensors need no wait."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _synchronize(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _synchronize(v)


class FrameMetrics:
    """Accumulates per-stage wall times and counters across frames."""

    def __init__(self):
        self.stage_s: dict[str, float] = defaultdict(float)
        self.stage_n: dict[str, int] = defaultdict(int)
        self.counters: dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time a stage; pass its result via ``sync`` (or set ``box["sync"]``
        on the yielded dict) to wait for the card before the clock stops,
        so the time is the work's and not its launch's
        (``torch.cuda.synchronize`` on a CUDA tensor's device; nothing for a
        CPU tensor)."""
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            _synchronize(box.get("sync", sync))
            self.stage_s[name] += time.perf_counter() - t0
            self.stage_n[name] += 1

    def count(self, name: str, value: float = 1.0):
        self.counters[name] += value

    def summary(self) -> dict:
        out = {}
        for name, total in self.stage_s.items():
            n = max(self.stage_n[name], 1)
            out[f"{name}_ms"] = round(total / n * 1e3, 3)
        frames = self.stage_n.get("frame", 0)
        if frames and "rays" in self.counters:
            total_frame_s = self.stage_s["frame"]
            out["rays_per_s"] = round(self.counters["rays"] / max(total_frame_s, 1e-9))
            out["frames_per_s"] = round(frames / max(total_frame_s, 1e-9), 3)
        out.update({k: v for k, v in self.counters.items()})
        return out

    def report(self) -> str:
        return json.dumps(self.summary())


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (the host, and the
    card where there is one) and write it to ``log_dir/trace.json`` as a
    Chrome trace (view it in Perfetto or ``chrome://tracing``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
