"""The readers of the program's own records (``harness/stages.py`` and the
metrics that use it) on a synthetic view and span list: the split at the
stage marks, the union inside a stage, the warm-up calls' replays, the
counters, and None where the program keeps none."""

from __future__ import annotations

import collections

import pytest

from benchmark.harness import cell, stages

Span = collections.namedtuple("Span", "name id parent request start_ns end_ns profiled units")

STAGE_METRICS = [f"{s}_ms.chained" for s in stages.STAGES]
PROGRAM_METRICS = STAGE_METRICS + ["graph_launch_ms.chained", "graph_nodes.chained",
                                   "scene_compile_s", "graph_capture_s"]


class Trace:
    def __init__(self, intervals, frames=2):
        self.view = {"intervals": sorted(intervals)}
        self.frames = frames


def mark(t, stage):
    return (t, t + 1.0, f"mcray_mark_{stage}")


# one call of one step: the call's own copy, then a mark before each stage's events
STEP = [
    (102.0, 104.0, "Memcpy HtoD"),
    mark(110.0, "draws"), (112.0, 120.0, "xor"), (118.0, 122.0, "add"),  # overlap: 10 us
    mark(130.0, "bounce_physics"), (132.0, 135.0, "mul"),
    mark(140.0, "prepass"), (142.0, 150.0, "min"),
    mark(151.0, "closest_hit"), (153.0, 160.0, "intersect_listed_kernel"), (161.0, 163.0, "gather"),
    mark(170.0, "bounce_physics"), (172.0, 174.0, "where"),
    mark(180.0, "march"), (182.0, 190.0, "march_kernel"),
    mark(200.0, "image"), (202.0, 205.0, "postproc_kernel"), (206.0, 207.0, "scan_convert_kernel"),
]


def test_the_view_splits_at_the_marks_and_unites_inside_a_stage():
    ms = stages.stage_ms(sorted(STEP))
    assert ms == pytest.approx({"draws": 0.010, "bounce_physics": 0.005, "prepass": 0.008,
                                "closest_hit": 0.009, "march": 0.008, "image": 0.004})
    for name, stage in zip(STAGE_METRICS, stages.STAGES):
        assert cell.reader(name)(Trace(STEP)) == pytest.approx(ms[stage] / 2)


def test_a_mark_is_found_in_a_decorated_event_name():
    assert stages.mark_of("void mcray_mark_closest_hit()") == "closest_hit"
    assert stages.mark_of("march_kernel") is None


def test_without_marks_the_stage_readers_read_none():
    plain = [iv for iv in STEP if "mcray_mark" not in iv[2]]
    assert stages.stage_ms(sorted(plain)) is None
    assert all(cell.reader(name)(Trace(plain)) is None for name in STAGE_METRICS)


def spans_of_a_run():
    """Host spans of the warm-up calls (0, which captures the graph, and 1),
    a profiled call (2) and two window calls (3, 4), two replays each, and
    the scene compile."""
    out = [Span("scene.compile", 1, None, None, 0, 2_000_000_000, False, 0),
           Span("chained.capture", 2, 3, 0, 2_500_000_000, 3_000_000_000, False, 8)]
    for request, start, replay_ns, profiled in ((0, 3_000_000_000, 400_000, False),
                                                (1, 4_000_000_000, 30_000, False),
                                                (2, 5_000_000_000, 900_000, True),
                                                (3, 6_000_000_000, 20_000, False),
                                                (4, 7_000_000_000, 20_000, False)):
        call = 10 * request + 3 if request else 3
        out += [Span("chained.replay", 10 * request + 4, call, request, start + k * replay_ns,
                     start + (k + 1) * replay_ns, profiled, 8) for k in range(2)]
        out.append(Span("chained.call", call, None, request, start - 1_000,
                        start + 2 * replay_ns, profiled, 16))
    return out


@pytest.fixture
def program(monkeypatch):
    counters = {"chained.graph_nodes": 5_520, "chained.graph_frames": 8}
    monkeypatch.setattr(stages, "records", lambda: (spans_of_a_run(), counters))


def test_graph_launch_ms_reads_the_warm_calls_after_the_capture(program):
    # the warm call 1: 2 replays of 0.03 ms, 16 frames; neither the call 0,
    # which captured the graph, nor the profiled call 2, nor the window's
    # calls 3 and 4, which follow it
    assert cell.reader("graph_launch_ms.chained")(Trace(STEP)) == pytest.approx(0.06 / 16)
    replays = stages.unprofiled_replays(spans_of_a_run())
    assert {s.request for s in replays} == {1}
    assert stages.unprofiled_replays([s for s in spans_of_a_run() if not s.profiled]) is None


def test_the_counters_and_set_up_spans(program):
    assert cell.reader("graph_nodes.chained")(Trace(STEP)) == 690.0
    assert cell.reader("scene_compile_s")(Trace(STEP)) == 2.0
    assert cell.reader("graph_capture_s")(Trace(STEP)) == 0.5


def test_without_the_programs_records_every_reader_reads_none(monkeypatch):
    monkeypatch.setattr(stages, "records", lambda: None)
    plain = [iv for iv in STEP if "mcray_mark" not in iv[2]]
    assert all(cell.reader(name)(Trace(plain)) is None for name in PROGRAM_METRICS)
    monkeypatch.setattr(stages, "records", lambda: ([], {}))
    assert all(cell.reader(name)(Trace(plain)) is None for name in PROGRAM_METRICS)


def test_the_program_keeps_the_records_the_readers_take():
    """The running program's recorder: spans with the fields the readers
    read, and counters (the CPU records spans; it counts no graph)."""
    got = stages.records()
    assert got is not None
    spans, counters = got
    assert isinstance(counters, dict)
    assert all(hasattr(s, f) for s in spans for f in Span._fields)
