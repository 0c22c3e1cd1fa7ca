"""The split of a fit step's traced device view at the program's stage marks,
the forward's six and the backward's four, beside ``stages.py`` (whose
arithmetic it shares and whose six stages it leaves as they are).

The program's fit step (``MaterialFitter``'s step on its buffers, replayed
from a CUDA graph) opens its stages with the marks ``mcray_mark_<stage>``:
the six of the forward (``stages.STAGES``, ``draws`` first), then
``image_bwd`` where the loss starts (the loss, its backward, the clamp's,
K9's and the postproc's), ``march_bwd`` when the gradient reaches the RF
image (K8, the packed segments' backward), ``trace_bwd`` when it reaches the
segments (the bounce physics' backward into the material table) and
``update`` after the backward (the mask, Adam, the clamp, and the call's
copies after a replay).
"""

from __future__ import annotations

from .profile import union_ms
from .stages import STAGES, mark_of

BACKWARD = ("image_bwd", "march_bwd", "trace_bwd", "update")
FIT_STAGES = STAGES + BACKWARD


def stage_ms(intervals) -> dict[str, float] | None:
    """Device ms by stage (``FIT_STAGES``) of sorted (start us, end us, name)
    intervals, as ``stages.stage_ms`` splits them: an event belongs to the
    stage whose mark last preceded it, a stage's time is the union of its
    events, the marks and the events before the first mark belong to none.
    None where no mark of a backward stage is in the view."""
    stage, by_stage = None, {s: [] for s in FIT_STAGES}
    for start, stop, name in intervals:
        mark = mark_of(name)
        if mark is not None:
            stage = mark
        elif stage in by_stage:
            by_stage[stage].append((start, stop))
    if not any(by_stage[s] for s in BACKWARD):
        return None
    return {s: union_ms(v) for s, v in by_stage.items()}


def per_frame(trace, names) -> float | None:
    """Device ms a frame of the stages ``names`` of the traced view."""
    ms = stage_ms(trace.view["intervals"])
    return None if ms is None else sum(ms[s] for s in names) / trace.frames
