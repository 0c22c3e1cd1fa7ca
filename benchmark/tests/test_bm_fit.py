"""A run of ``sphere_soft.fit``, driven on the CPU at a small acquisition and
mix past the look for a card: a sound fit comes out correct, and a fit
broken underneath comes out not correct, once for each fault the cell can
have: Adam fed the previous step's gradient (a stale gradient), the
gradient scaled by 1.1, Adam's step count frozen at its first, half of a
step's frames copied from the other half. Besides: the split of a fit
step's traced view at its ten stage marks, and the backward kernels' floors
on the configuration's shapes. On the card (``-m cuda``): the captured step
against the eager one."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness import cell, fit_roofline, fit_stages, runner
from benchmark.tests.helpers import SMALL
from mcray_tpu_torch.models import simulator

FIT_MIX = {"n_frames_per_step": 2, "n_steps": 2, "warm_calls": 1, "sample": 1}
FIT_ACQ = {**SMALL, "transducer_elements": 32, "max_depth": 4}


def run(seconds=1.0):
    return runner.run_cell("sphere_soft.fit", 2**31 + 4243, seconds, False,
                           t_start=time.perf_counter(), device="cpu", acquisition=FIT_ACQ,
                           mix=FIT_MIX)["result"]


def test_a_sound_fit_is_correct():
    result = run()
    assert result["correct"] and result["failed"] == 0, result["check"]
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
    assert result["check"]["frames_compared"]["value"] == FIT_MIX["n_frames_per_step"] + 2
    assert result["check"]["rel_l2_max"]["value"] < 1e-5


def adam_fault(change):
    """``torch.optim.Adam.step`` with ``change(optimizer, param)`` first."""
    orig = torch.optim.Adam.step

    def step(self, *args, **kw):
        for group in self.param_groups:
            for p in group["params"]:
                change(self, p)
        return orig(self, *args, **kw)
    return step


def stale(opt, p):
    fresh = p.grad.clone()
    if getattr(opt, "_stale", None) is not None:
        p.grad.copy_(opt._stale)
    opt._stale = fresh


def scaled(opt, p):
    p.grad.mul_(1.1)


def frozen(opt, p):
    if "step" in opt.state[p]:
        opt.state[p]["step"].zero_()


@pytest.mark.parametrize("fault", [stale, scaled, frozen], ids=lambda f: f.__name__)
def test_a_fit_with_a_broken_update_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(torch.optim.Adam, "step", adam_fault(fault))
    assert not run()["correct"]


def test_a_fit_with_half_its_frames_copied_is_not_correct(monkeypatch):
    orig = simulator.Simulator.render_batch

    def half(self, *args, **kw):
        out = orig(self, *args, **kw)
        n = out.shape[0]
        return torch.cat([out[: n - n // 2], out[: n // 2]])

    monkeypatch.setattr(simulator.Simulator, "render_batch", half)
    assert not run()["correct"]


class Trace:
    def __init__(self, intervals, frames=2):
        self.view = {"intervals": sorted(intervals)}
        self.frames = frames


def mark(t, stage):
    return (t, t + 1.0, f"mcray_mark_{stage}")


def test_the_fit_step_splits_at_its_ten_marks():
    step = [mark(100.0, "draws"), (102.0, 104.0, "fold"), mark(105.0, "bounce_physics"),
            (106.0, 110.0, "mul"), mark(111.0, "prepass"), (112.0, 113.0, "min"),
            mark(114.0, "closest_hit"), (115.0, 117.0, "intersect_listed_kernel"),
            mark(118.0, "bounce_physics"), (119.0, 120.0, "where"), mark(121.0, "march"),
            (122.0, 126.0, "march_kernel"), mark(127.0, "image"), (128.0, 130.0, "postproc"),
            mark(131.0, "image_bwd"), (132.0, 135.0, "scanconv_bwd_kernel"),
            (134.0, 137.0, "mul"), mark(138.0, "march_bwd"), (139.0, 145.0, "march_bwd_kernel"),
            mark(146.0, "trace_bwd"), (147.0, 155.0, "index_add"), mark(156.0, "update"),
            (157.0, 158.0, "adam"), (159.0, 160.0, "copy")]
    ms = fit_stages.stage_ms(sorted(step))
    assert ms == {"draws": 0.002, "prepass": 0.001, "closest_hit": 0.002,
                  "bounce_physics": 0.005, "march": 0.004, "image": 0.002, "image_bwd": 0.005,
                  "march_bwd": 0.006, "trace_bwd": 0.008, "update": 0.002}
    assert fit_stages.per_frame(Trace(step), ("image_bwd",)) == 0.0025
    assert fit_stages.stage_ms(sorted(step[:13])) is None  # a forward alone: not a fit step
    for name in ("forward_ms.fit", "image_bwd_ms.fit", "march_bwd_ms.fit", "trace_bwd_ms.fit",
                 "update_ms.fit"):
        assert cell.reader(name)(Trace(step)) > 0
        assert cell.reader(name)(Trace(step[:13])) is None


def test_the_backward_floors_are_the_bytes_of_the_configuration():
    p = cell.config("sphere_soft")["acquisition"]
    # K8: 50 segments x 16 fields x 4,096 columns read and written, the RF cotangent read
    soa = 50 * 16 * 4096 * 4
    assert fit_roofline.march_bwd_floor_ms(p, 8) == pytest.approx(
        (2 * soa + 4 * 465 * 4096) / 3.35e12 * 1e3)
    # K9: 8 cotangents and the two maps read, 8 RF gradients written
    assert fit_roofline.scanconv_bwd_floor_ms(p, 8) == pytest.approx(
        (4 * 8 * 200_000 + 8 * 200_000 + 4 * 8 * 465 * 512) / 3.35e12 * 1e3)


class Fake:
    def __init__(self, view, frames):
        self.view, self.frames = view, frames

    def kernel_ms(self, name):
        return sum(ms for k, ms in self.view["by_name"].items() if name in k)


def test_a_share_is_the_floor_over_the_device_ms_a_launch():
    p = fit_roofline.acquisition()
    view = {"by_name": {"march_bwd_kernel(float const*)": 2.0},
            "count_by_name": {"march_bwd_kernel(float const*)": 4}}
    share = cell.reader("march_bwd_pct_of_roofline.fit")(Fake(view, 32))
    assert share == pytest.approx(100.0 * fit_roofline.march_bwd_floor_ms(p, 8) / 0.5)
    assert cell.reader("scanconv_bwd_pct_of_roofline.fit")(Fake(view, 32)) is None


@pytest.mark.cuda
def test_the_captured_fit_step_equals_the_eager_one():
    """On the card, a fitter's captured steps against another's eager ones
    from the same start: the first loss bitwise, the losses of three steps
    and the tables within 1e-5 (the backward's gathers add with atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark.harness import traffic
    from benchmark.reference import rng as ref_rng

    conf = cell.config("sphere_soft")
    mix = {**cell.traffic("fit_8x16"), **FIT_MIX}
    graph, eager = (traffic.make(mix, runner.Context(conf, {**conf["acquisition"], **FIT_ACQ}, 7,
                                                     "cuda")) for _ in range(2))
    start = graph.start(11)
    graph.fit.state, eager.fit.state = start, start
    got = graph.fit.run(3, 11, verbose=False)
    want = [eager.fit.step(ref_rng.fold_in(ref_rng.prng_key(11), i)) for i in range(3)]
    assert graph.fit.graph is not None and eager.fit.graph is None
    assert got[0] == want[0]
    torch.testing.assert_close(torch.tensor(got), torch.tensor(want), rtol=1e-5, atol=0)
    torch.testing.assert_close(graph.fit.state.materials, eager.fit.state.materials, rtol=1e-5,
                               atol=1e-7)
