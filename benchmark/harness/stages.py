"""The arithmetic of the per-layer metrics read from the program's own
records: the split of the traced device view at its stage marks, and the
host spans of its graph launches and set-up.

The program (``mcray_tpu_torch/utils/profiling.py``) launches an empty
kernel ``mcray_mark_<stage>`` where each stage of a chained step starts
(captured into the step's CUDA graph, so it runs at every replay). It keeps
host spans (``name``, ``id``, ``parent``, ``request``, ``start_ns``,
``end_ns`` in ``time.perf_counter_ns()``, ``profiled``, ``units``: frames)
and counters. The readers take those raw records (``records()``) and
compute here; each returns None where the program keeps no such records (a
program without them, or the CPU, which the profiler does not trace).
"""

from __future__ import annotations

import re

from .profile import union_ms

MARK = "mcray_mark_"
STAGES = ("draws", "prepass", "closest_hit", "bounce_physics", "march", "image")
CALL, REPLAY, CAPTURE = "chained.call", "chained.replay", "chained.capture"


def mark_of(name: str) -> str | None:
    """The stage of a mark's device event name, or None for any other event."""
    found = re.search(MARK + r"(\w+)", name)
    return found.group(1) if found else None


def records():
    """(spans, counters) of the program's recorder, or None where it has none."""
    try:
        from mcray_tpu_torch.utils import profiling

        return profiling.spans(), profiling.counters()
    except (ImportError, AttributeError):
        return None


def stage_ms(intervals) -> dict[str, float] | None:
    """Device ms by stage of sorted (start us, end us, name) intervals: an
    event belongs to the stage whose mark last preceded it, and a stage's
    time is the union of its events (in the order the view gives them). The
    marks, and events before the first stage mark (a call's own set-up),
    belong to none. None where no stage mark is in the view."""
    stage, by_stage, marked = None, {s: [] for s in STAGES}, False
    for start, stop, name in intervals:
        mark = mark_of(name)
        if mark is not None:
            stage, marked = mark, marked or mark in by_stage
        elif stage in by_stage:
            by_stage[stage].append((start, stop))
    return {s: union_ms(v) for s, v in by_stage.items()} if marked else None


def unprofiled_replays(spans) -> list | None:
    """The ``chained.replay`` spans of the warm-up calls: those made before
    the first profiled call, which no profiler has touched (the window's
    calls follow a profiled one, and a long trace can leave the window
    none), less the call that captured the graph (its replays right after
    the capture are not the steady launch). None without a profiled call."""
    profiled = [s.request for s in spans if s.name == CALL and s.profiled]
    if not profiled:
        return None
    first = min(profiled)
    captured = {s.request for s in spans if s.name == CAPTURE}
    return [s for s in spans if s.name == REPLAY and not s.profiled and s.request < first
            and s.request not in captured]


def longest_s(spans, name: str) -> float | None:
    """Seconds of the longest span ``name``, or None."""
    ns = [s.end_ns - s.start_ns for s in spans if s.name == name]
    return max(ns) / 1e9 if ns else None
