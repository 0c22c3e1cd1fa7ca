"""Per-stage timing and frame metrics, and the program's own tracing.

Port of ``mcray_tpu/utils/profiling.py``: a registry of wall-clock stage
timers and counters with rays/s accounting (``FrameMetrics``, the same
summary keys), and ``device_trace``, a ``torch.profiler`` trace written as
a Chrome trace (the reference captures a ``jax.profiler`` trace).

The tracing that lives inside the program, because the timed paths of the
chained batch and of the material fit are CUDA graph replays, where a host
range around a stage runs once, at capture:

- ``mark(stage, device)``: an empty kernel, ``mcray_mark_<stage>``
  (``csrc/marks.cu``), launched where a stage of the step starts, in the
  order of ``STAGES``; it launches only while the current stream captures a
  graph or a torch profiler is active, so a trace of the replays splits by
  stage at the marks, and eager frames outside a profiler launch nothing
  more. ``grad_mark(stage, *tensors)`` is the same mark for a stage of the
  backward: an identity on the tensors whose backward launches it, when
  the gradient reaches them (nothing at all where no gradient is taken).
- Spans (``span``): name, id, parent, request id, start and end in
  ``time.perf_counter_ns()``, whether a profiler was active, and the frames
  (``units``) the span rendered, kept in a bounded ring. No span is a
  device event.
- Counters (``count``): numbers that a graph replay would otherwise hide.

One ``Recorder`` (``RECORDER``) serves the process; ``spans()`` and
``counters()`` read it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
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


#: the stages of a step in the order their marks open them (``csrc/marks.cu``'s
#: ``mcray_mark`` takes the index): the forward's six, in a chained step and
#: in a fit step, then a fit step's four: the loss and the image's backward
#: (K9 and the postproc's), the march's (K8 and the packed segments'), the
#: trace's (the bounce physics into the material table), the update (the mask,
#: Adam and the clamp)
STAGES = ("draws", "prepass", "closest_hit", "bounce_physics", "march", "image",
          "image_bwd", "march_bwd", "trace_bwd", "update")
#: spans the ring keeps
SPAN_CAPACITY = 65_536

Span = collections.namedtuple("Span", "name id parent request start_ns end_ns profiled units")


def profiler_active() -> bool:
    """Whether a torch profiler is recording."""
    return torch.autograd.profiler._is_profiler_enabled


def tracing(device) -> bool:
    """Whether a mark on ``device`` launches: a CUDA device whose current
    stream is capturing a graph, or under an active torch profiler."""
    return torch.device(device).type == "cuda" and (
        profiler_active() or torch.cuda.is_current_stream_capturing())


def mark(stage: str, device) -> None:
    """Launch the mark of ``stage`` (one of ``STAGES``) on ``device``'s
    current stream, where ``tracing(device)``; nothing otherwise."""
    if not tracing(device):
        return
    from ..ops.cuda import _build

    _build.launch("mcray_mark", STAGES.index(stage), device=device)


class _GradMark(torch.autograd.Function):
    """The identity, whose backward launches the mark of ``stage`` once the
    gradients of all its outputs are in."""

    @staticmethod
    def forward(ctx, stage, *tensors):
        ctx.stage, ctx.device = stage, tensors[0].device
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        mark(ctx.stage, ctx.device)
        return (None, *grads)


def grad_mark(stage: str, *tensors: torch.Tensor) -> tuple:
    """``tensors``, through an identity whose backward launches the mark of
    ``stage`` (``mark``: under a capture or a profiler only) when the
    gradient reaches them; unchanged where grad mode is off or none of them
    requires grad, so a step without a backward gains no node. The
    gradients pass through as they come."""
    if not torch.is_grad_enabled() or not any(t.requires_grad for t in tensors):
        return tensors
    return _GradMark.apply(stage, *tensors)


def capture_nodes(device) -> int:
    """Nodes of the CUDA graph that ``device``'s current stream is capturing."""
    from ..ops.cuda import _build

    n = _build.library().mcray_capture_nodes(torch.cuda.current_stream(device).cuda_stream)
    if n < 0:
        raise RuntimeError("capture_nodes: the current stream is capturing no graph")
    return n


class _Open:
    """The context of one open span (``Recorder.span``)."""

    __slots__ = ("rec", "name", "request", "units", "id", "parent", "start", "profiled")

    def __init__(self, rec, name, request, units):
        self.rec, self.name, self.request, self.units = rec, name, request, units

    def __enter__(self):
        stack = self.rec._stack()
        self.parent = stack[-1].id if stack else None
        if self.request is None and stack:
            self.request = stack[-1].request
        self.id = next(self.rec._ids)
        self.profiled = profiler_active()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.rec._stack().pop()
        self.rec._record(Span(self.name, self.id, self.parent, self.request, self.start, end,
                              self.profiled, self.units))
        return False


class Recorder:
    """Host spans in a ring of ``capacity``, and counters. A span's parent
    is the innermost span open on its thread when it opened; it takes its
    parent's request id unless it is given one."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self._ring = collections.deque(maxlen=capacity)
        self._counters: dict[str, int] = defaultdict(int)
        self._ids = itertools.count(1)
        self._requests = itertools.count()
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, span: Span) -> None:
        with self._lock:
            self._ring.append(span)

    def request(self) -> int:
        """A new request id (the index of a call)."""
        return next(self._requests)

    def span(self, name: str, *, request: int | None = None, units: int = 0) -> _Open:
        """``with recorder.span(name):`` records the block as a span;
        ``units`` are the frames it renders."""
        return _Open(self, name, request, units)

    def count(self, name: str, value: int = 1) -> None:
        with self._lock:
            self._counters[name] += value

    def spans(self) -> list[Span]:
        """The spans the ring holds, in the order they closed."""
        with self._lock:
            return list(self._ring)

    def last_ms(self, name: str) -> float | None:
        """ms of the span ``name`` that closed last, or None."""
        with self._lock:
            last = next((s for s in reversed(self._ring) if s.name == name), None)
        return None if last is None else (last.end_ns - last.start_ns) / 1e6

    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)


#: the process's recorder
RECORDER = Recorder()
request, span, count = RECORDER.request, RECORDER.span, RECORDER.count
spans, counters, last_ms = RECORDER.spans, RECORDER.counters, RECORDER.last_ms

