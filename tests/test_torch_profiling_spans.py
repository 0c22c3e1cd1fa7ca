"""The port's own tracing on the CPU (``mcray_tpu_torch/utils/profiling.py``):
host spans nest, a chained call is one request, the ring stays bounded; a
stage mark launches only for a CUDA device under a capture or a profiler,
and a step marks its stages in order in every closest-hit mode; the launch
counters count each of a chained call's eager steps, add a graph's
replays, and count a captured launch in its capture's tally alone; a
``GraphStep`` on the CPU runs its step eagerly. The marks on the card, in a replayed
graph: ``tests/test_torch_cuda.py::test_chained_call_marks_every_stage_and_counts_its_replays``.
~5 s."""

from __future__ import annotations

import functools
import types

import pytest
import torch

from _torch_port import SPHERE_SCENE
from mcray_tpu_torch.config import small_test_config
from mcray_tpu_torch.models.graph_step import GraphStep
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.ops import cuda as kernels
from mcray_tpu_torch.ops.cuda import _build, intersect_listed, march, postproc, scanconv
from mcray_tpu_torch.scene.compile import load_and_compile
from mcray_tpu_torch.utils import profiling


@functools.lru_cache(maxsize=None)
def _simulator() -> Simulator:
    cfg = small_test_config(transducer_elements=16, samples_per_element=1)
    return Simulator(load_and_compile(SPHERE_SCENE), cfg, device="cpu", seed=1)


def test_spans_nest_and_take_their_parents_request():
    rec = profiling.Recorder()
    with rec.span("call", request=rec.request(), units=6) as call:
        with rec.span("replay", units=2) as first:
            with rec.span("inner"):
                pass
        with rec.span("replay", units=2):
            pass
    with rec.span("call", request=rec.request()):
        pass
    got = {(s.name, s.id): s for s in rec.spans()}
    assert [s.name for s in rec.spans()] == ["inner", "replay", "replay", "call", "call"]
    inner, = (s for s in rec.spans() if s.name == "inner")
    assert inner.parent == first.id and got[("replay", first.id)].parent == call.id
    assert got[("call", call.id)].parent is None
    requests = [s.request for s in rec.spans()]
    assert requests == [0, 0, 0, 0, 1]
    for s in rec.spans():
        assert s.end_ns >= s.start_ns and s.profiled is False
    assert [s.units for s in rec.spans() if s.name == "replay"] == [2, 2]


def test_a_span_records_whether_a_profiler_was_active():
    rec = profiling.Recorder()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with rec.span("traced"):
            pass
    with rec.span("plain"):
        pass
    assert [(s.name, s.profiled) for s in rec.spans()] == [("traced", True), ("plain", False)]


def test_the_ring_stays_bounded_and_keeps_the_counters():
    rec = profiling.Recorder(capacity=8)
    for i in range(20):
        with rec.span("step", request=i, units=3):
            pass
        rec.count("steps")
    kept = rec.spans()
    assert len(kept) == 8 and [s.request for s in kept] == list(range(12, 20))
    assert rec.counters() == {"steps": 20}


class _Library:
    """Records the stages ``mcray_mark`` is asked to launch."""

    def __init__(self):
        self.stages = []

    def mcray_mark(self, stage, stream):
        self.stages.append(profiling.STAGES[stage])
        return 0


@pytest.fixture
def library(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def test_no_mark_name_holds_a_kernel_name():
    """The measuring code finds a kernel's events by a substring of their
    names (``utils/roofline.py:EVENT_NAMES``): no mark may match one."""
    from mcray_tpu_torch.utils.roofline import EVENT_NAMES

    marks = [f"mcray_mark_{stage}" for stage in profiling.STAGES]
    assert not [(m, k) for m in marks for k in EVENT_NAMES.values() if k in m]


@pytest.mark.parametrize("capturing", [False, True])
def test_a_mark_launches_only_for_a_cuda_device_under_a_capture_or_a_profiler(
        monkeypatch, library, capturing):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    profiling.mark("draws", "cpu")
    profiling.mark("prepass", torch.device("cuda"))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.mark("march", "cpu")
        profiling.mark("image", "cuda")
    assert library.stages == (["prepass"] if capturing else []) + ["image"]


@pytest.mark.parametrize("mode, bounce", [
    ({}, ["prepass", "closest_hit", "bounce_physics"]),
    ({"intersect_mode": "grouped"}, ["closest_hit", "bounce_physics"]),
    ({"use_bvh": True}, ["closest_hit", "bounce_physics"]),
    ({"use_culled_intersect": False}, ["closest_hit", "bounce_physics"]),
], ids=["listed", "grouped", "bvh", "brute"])
def test_a_step_marks_its_stages_in_order_in_each_closest_hit_mode(monkeypatch, library, mode,
                                                                   bounce):
    """Where marks launch, a step opens ``draws``, the trace (``bounce_physics``
    before the first bounce), each bounce's closest hit and physics, then
    ``march`` and ``image``; only the listed mode splits its prepass off."""
    monkeypatch.setattr(profiling, "tracing", lambda device: True)
    cfg = small_test_config(transducer_elements=16, samples_per_element=1)
    sim = Simulator(load_and_compile(SPHERE_SCENE), cfg, device="cpu", seed=1, **mode)
    sim.make_chained_batch(2, 1).step()
    assert library.stages == (["draws", "bounce_physics"] + bounce * cfg.max_depth
                              + ["march", "image"])


def test_a_chained_call_on_the_cpu_marks_nothing_and_is_one_request(library):
    chained = _simulator().make_chained_batch(2, 3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        chained(7)
    chained(8)
    assert library.stages == []
    calls = [s for s in profiling.spans() if s.name == "chained.call"][-2:]
    assert [c.units for c in calls] == [6, 6] and [c.profiled for c in calls] == [True, False]
    assert calls[1].request == calls[0].request + 1 and calls[0].parent is None
    # the CPU replays no graph
    assert not [s for s in profiling.spans() if s.request in {c.request for c in calls}
                and s.name != "chained.call"]


def test_the_scene_compile_is_a_span():
    before = [s.id for s in profiling.spans() if s.name == "scene.compile"]
    load_and_compile(SPHERE_SCENE)
    after = [s for s in profiling.spans() if s.name == "scene.compile"]
    assert len(after) == len(before) + 1
    last = after[-1]
    assert last.id not in before and last.end_ns > last.start_ns and last.parent is None


def _counting(mod, plain, kernel):
    fn = getattr(mod, plain)

    def call(*args, **kw):
        kernels.add_launch_counts({kernel: 1})
        return fn(*args, **kw)
    return call


def test_launch_counts_count_each_eager_step_of_a_chained_call(monkeypatch):
    """The plain versions stand in for launches (the CPU launches nothing):
    a call of 3 steps counts 3 steps' launches, none twice."""
    sim = _simulator()
    for mod, plain, kernel in ((intersect_listed, "listed_best_plain", "intersect_listed"),
                               (march, "march_plain", "march"),
                               (postproc, "postproc_plain", "postproc"),
                               (scanconv, "scan_convert_plain", "scanconv")):
        monkeypatch.setattr(mod, plain, _counting(mod, plain, kernel))
    chained = sim.make_chained_batch(2, 3)
    kernels.reset_launch_counts()
    chained(5)
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    kernels.reset_launch_counts()
    sim.render_frames(chained.step_keys())
    step = {k: v for k, v in kernels.launch_counts().items() if v}
    assert step == {"intersect_listed": sim.cfg.max_depth, "march": 1, "postproc": 1,
                    "scanconv": 1}
    assert counts == {k: 3 * v for k, v in step.items()}


def test_add_launch_counts_adds_a_graphs_replays():
    kernels.reset_launch_counts()
    kernels.add_launch_counts({"intersect_listed": 10, "march": 1, "scanconv_bwd": 1}, 4)
    kernels.add_launch_counts({"intersect_listed": 10})
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    kernels.reset_launch_counts()
    assert counts == {"intersect_listed": 50, "march": 4, "scanconv_bwd": 4}
    assert not any(kernels.launch_counts().values())


#: every kernel ``launch_counts`` names
KERNEL_NAMES = ("intersect", "intersect_listed", "intersect_culled", "intersect_staged",
                "intersect_grouped", "bvh_intersect", "march", "march_bwd", "postproc",
                "scanconv", "scanconv_bwd", "draws", "bounce", "bounce_bwd")


def test_launch_counts_name_every_kernel_and_refuse_an_unknown_name():
    kernels.add_launch_counts({"march": 2})
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == dict.fromkeys(KERNEL_NAMES, 0)
    with pytest.raises(KeyError, match="nope"):
        kernels.add_launch_counts({"march": 1, "nope": 1})
    assert kernels.launch_counts() == dict.fromkeys(KERNEL_NAMES, 0)


class _Kernels:
    """Stands in for the library's launch entries: each returns ``code`` and
    reports a grid of 7 blocks where the entry reports one."""

    def __init__(self, code=0):
        self.code = code

    def __getattr__(self, entry):
        def launch(*args):
            if _build.ENTRIES[entry].grid:
                args[-2]._obj.value = 7
            return self.code
        return launch


@pytest.fixture
def stand_in(monkeypatch):
    def use(capturing: bool, code: int = 0):
        monkeypatch.setattr(_build, "library", lambda: _Kernels(code))
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device=None: types.SimpleNamespace(cuda_stream=0))
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    kernels.reset_launch_counts()
    yield use
    kernels.reset_launch_counts()


def test_a_launch_counts_in_the_totals_and_keeps_its_grid(stand_in):
    """An eager launch counts under its kernel (both draws entries under
    ``draws``) and keeps the grid its entry reports; one the entry refuses
    (code 1) raises ``ValueError`` and counts nothing; a mark counts nowhere."""
    stand_in(capturing=False)
    _build.launch("mcray_march_bwd", device="cuda")
    _build.launch("mcray_keyed_draws", device="cuda")
    _build.launch("mcray_fold_in", device="cuda")
    _build.launch("mcray_mark", 0, device="cuda")
    assert {k: v for k, v in kernels.launch_counts().items() if v} == {"march_bwd": 1, "draws": 2}
    assert kernels.last_grid("march_bwd") == 7
    stand_in(capturing=False, code=1)
    with pytest.raises(ValueError, match="mcray_bounce"):
        _build.launch("mcray_bounce", None, device="cuda")
    assert kernels.launch_counts()["bounce"] == 0


def test_a_captured_launch_counts_in_the_captures_tally_not_in_the_totals(stand_in):
    """A launch while the current stream captures goes to the open capture's
    tally; with no tally open (a timing tool's capture) it counts nowhere."""
    stand_in(capturing=True)
    with _build.tallied() as tally:
        _build.launch("mcray_intersect_listed", device="cuda")
        _build.launch("mcray_intersect_listed", device="cuda")
        _build.launch("mcray_scan_convert", device="cuda")
    _build.launch("mcray_march", device="cuda")
    assert dict(tally) == {"intersect_listed": 2, "scanconv": 1}
    assert not any(kernels.launch_counts().values())
    assert kernels.last_grid("scanconv") == 7


def test_a_graph_step_on_the_cpu_runs_its_step_n_times_in_order():
    """On the CPU a ``GraphStep`` runs its step eagerly, once a step, hands
    each step's outputs to ``each`` and returns the last; it captures
    nothing and opens no capture or replay span under its call."""
    done = []

    def step():
        done.append(len(done))
        return {"i": done[-1]}

    counters = profiling.counters()
    graph = GraphStep(step, "cpu", "probe", 2)
    seen = []
    with profiling.span("probe.call", request=profiling.request()) as call:
        out = graph.run(3, lambda o: seen.append(o["i"]))
        graph.capture()
    assert done == seen == [0, 1, 2] and out == {"i": 2}
    assert graph.graph is None and graph.launches == {}
    assert graph.run(0) is None and done == [0, 1, 2]
    assert not [s for s in profiling.spans() if s.request == call.request
                and s.name != "probe.call"]
    assert profiling.counters() == counters
