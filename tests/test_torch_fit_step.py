"""The material fit's step on the buffers (``MaterialFitter.run``), on the CPU.

At a small soft + trilinear acquisition (``small_test_config`` at 32 x 2, or
16 x 2 and 4 bounces where only the port is run) with the trained entries of LIVER and
BONE perturbed by seeded log-uniform factors in [0.5, 2] (seeds 3, 5, 8,
whose paths graze no triangle edge or cluster box, so the port, whose CPU
path walks a packet's clusters whole, and the reference, which walks them
four rays at a time as the card's kernel does, trace the same paths):

- the port's step against the benchmark's plain reference of it
  (``benchmark/reference/fit.py``, plain torch, no code of the port): the
  frames and the loss bitwise (the CPU runs the plain versions of the
  kernels, the reference's operations in the same order); the masked
  gradient within a relative L2 gap of 1e-5 (the march's backward sums the
  hand-derived partials of ``march_bwd_plain`` where the reference sums
  autograd's, the same terms in another order, a few f32 ulps); the update
  (``torch.optim.Adam`` against the written-out formulas, from the same
  moments) within 1e-5, each relative to the reference's L2 norm;
- ``run`` against the eager ``step`` loop of the same keys (or the same
  fixed draws): losses, tables and Adam's state bitwise;
- the step with its backward marks against the step without them: loss
  and gradient bitwise, and the marks in the order of the stages;
- the spans of a call as recorded.

Each test's time on one core of this box: the reference comparison ~9-12 s
a seed, the loops ~6-7 s each, the new start ~5 s, the marks ~5 s, the spans
~2 s; ~60 s in all.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from _torch_port import SPHERE_SCENE
from benchmark.reference.fit import FitReference
from mcray_tpu_torch.config import small_test_config
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.models.trainer import FitState, MaterialFitter
from mcray_tpu_torch.scene.compile import load_and_compile
from mcray_tpu_torch.utils import profiling, rng

ROWS = (3, 4)  # LIVER and BONE
LR = 1e-2
TEXTURE_SEED = 1234
GRAD_REL, UPDATE_REL = 1e-5, 1e-5


def config(elements: int, max_depth: int = 10):
    return small_test_config(transducer_elements=elements, samples_per_element=2,
                             max_depth=max_depth, soft_scattering=True, trilinear_texture=True)


@pytest.fixture(scope="module")
def pack():
    return load_and_compile(SPHERE_SCENE)


def perturbed(materials: torch.Tensor, seed: int) -> torch.Tensor:
    """The trained entries times log-uniform factors in [0.5, 2] of ``seed``."""
    start = materials.clone()
    factors = np.exp(np.random.default_rng(seed).uniform(np.log(0.5), np.log(2.0), (2, 5)))
    start[list(ROWS), :5] *= torch.tensor(factors, dtype=torch.float32)
    return start


def fitter(sim, seed: int, n_frames: int = 2, **kw) -> MaterialFitter:
    with torch.no_grad():
        target = sim.render_compound(rng.split(rng.prng_key(77), n_frames))
    return MaterialFitter.from_simulator(sim, perturbed(sim.materials, seed), target,
                                         trainable_rows=list(ROWS), n_frames_per_step=n_frames,
                                         learning_rate=LR, **kw)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((got - want).double())
                 / torch.linalg.vector_norm(want.double()))


@pytest.mark.parametrize("seed", [3, 5, 8])
def test_the_step_matches_the_plain_reference(pack, seed):
    """The second step of a fit (Adam's moments no longer zero) against the
    reference's step from the table and moments before it."""
    cfg = config(32)
    sim = Simulator(pack, cfg, device="cpu", seed=TEXTURE_SEED)
    acq = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    mesh_dir = os.path.dirname(SPHERE_SCENE)
    ref = FitReference(acq, SPHERE_SCENE, mesh_dir, TEXTURE_SEED, "cpu")
    fit = fitter(sim, seed)
    fit.run(1, seed=seed + 100, verbose=False)
    before = fit.state
    (loss,) = fit.run(1, seed=seed + 100, verbose=False)
    keys = rng.split(rng.fold_in(rng.prng_key(seed + 100), 1), 2)
    want = ref.step(before.materials, before.opt_state["exp_avg"],
                    before.opt_state["exp_avg_sq"], 1, keys, fit.target, fit.mask, LR)
    assert torch.equal(fit.last_frames, want["bmode"])
    assert loss == float(want["loss"])
    assert float(want["grad"].abs().max()) > 0
    assert rel_l2(fit.last_grad, want["grad"]) <= GRAD_REL
    assert rel_l2(fit.state.materials - before.materials, want["update"]) <= UPDATE_REL
    # the mask: every untrained entry unchanged
    untouched = fit.mask == 0
    assert torch.equal(fit.state.materials[untouched], before.materials[untouched])


def test_the_reference_refuses_what_it_does_not_compute(pack):
    acq = {f: getattr(config(32), f) for f in config(32).__dataclass_fields__}
    with pytest.raises(ValueError, match="envelope_mode"):
        FitReference({**acq, "envelope_mode": "hilbert"}, SPHERE_SCENE,
                      os.path.dirname(SPHERE_SCENE), TEXTURE_SEED, "cpu")


def _same_state(a: MaterialFitter, b: MaterialFitter) -> None:
    sa, sb = a.state, b.state
    assert torch.equal(sa.materials, sb.materials) and sa.step == sb.step
    for key in ("exp_avg", "exp_avg_sq"):
        assert torch.equal(sa.opt_state[key], sb.opt_state[key])
    assert sa.opt_state["step"] == sb.opt_state["step"]


@pytest.mark.parametrize("fixed", [False, True], ids=["keyed", "fixed_draws"])
def test_run_equals_the_eager_step_loop(pack, fixed):
    """Two steps of ``run`` against two calls of ``step`` with the keys
    ``fold_in(prng_key(seed), i)`` (or the fixed draws): bitwise."""
    sim = Simulator(pack, config(16, 4), device="cpu", seed=TEXTURE_SEED)
    kw = {"n_frames": 1, "fixed_frame": sim.draws(4)} if fixed else {}
    a, b = fitter(sim, 5, **kw), fitter(sim, 5, **kw)
    got = a.run(2, seed=21, verbose=False)
    want = [b.step(kw["fixed_frame"] if fixed else rng.fold_in(rng.prng_key(21), i))
            for i in range(2)]
    assert got == want and got[0] != got[1]
    _same_state(a, b)
    assert torch.equal(a.last_grad, b.last_grad) and torch.equal(a.last_frames, b.last_frames)


def test_a_new_start_through_state_gives_the_fresh_fits_steps(pack):
    """A fitter that ran, then given another start (table, zero moments, step
    0) through ``state``, takes the steps a fresh fitter from that start
    takes."""
    sim = Simulator(pack, config(16, 4), device="cpu", seed=TEXTURE_SEED)
    used, fresh = fitter(sim, 3), fitter(sim, 8)
    used.run(1, seed=1, verbose=False)
    zeros = torch.zeros_like(fresh.state.materials)
    used.state = FitState(perturbed(sim.materials, 8), {"exp_avg": zeros, "exp_avg_sq": zeros,
                                                        "step": 0}, 0)
    assert used.run(1, seed=9, verbose=False) == fresh.run(1, seed=9, verbose=False)
    _same_state(used, fresh)


def test_the_backward_marks_leave_the_step_unchanged(pack, monkeypatch):
    """A step marks its stages in order (forward, then ``image_bwd`` at the
    loss, ``march_bwd`` and ``trace_bwd`` in the backward, ``update``), and
    its loss and gradient are bitwise those of a step whose backward has no
    marks."""
    sim = Simulator(pack, config(16, 4), device="cpu", seed=TEXTURE_SEED)
    marked, plain = fitter(sim, 3), fitter(sim, 3)
    stages = []
    monkeypatch.setattr(profiling, "mark", lambda stage, device: stages.append(stage))
    loss = marked.run(1, seed=2, verbose=False)
    d = sim.cfg.max_depth
    assert stages == (["draws", "bounce_physics"] + ["prepass", "closest_hit", "bounce_physics"] * d
                      + ["march", "image", "image_bwd", "march_bwd", "trace_bwd", "update"])
    monkeypatch.setattr(profiling, "grad_mark", lambda stage, *tensors: tensors)
    assert plain.run(1, seed=2, verbose=False) == loss
    assert torch.equal(plain.last_grad, marked.last_grad)
    assert stages.count("march_bwd") == stages.count("trace_bwd") == 1
    assert float(marked.last_grad.abs().max()) > 0


def test_a_call_is_one_span_with_its_frames_and_replays_nothing_on_the_cpu(pack):
    sim = Simulator(pack, config(16, 4), device="cpu", seed=TEXTURE_SEED)
    fit = fitter(sim, 5)
    counters = profiling.counters()
    fit.run(1, seed=4, verbose=False)
    fit.run(0, seed=4, verbose=False)
    calls = [s for s in profiling.spans() if s.name == "fit.call"][-2:]
    assert [c.units for c in calls] == [2, 0] and calls[1].request == calls[0].request + 1
    assert not [s for s in profiling.spans() if s.request in {c.request for c in calls}
                and s.name != "fit.call"]
    assert fit.graph is None and fit.launches == {}
    assert {k: v for k, v in profiling.counters().items() if k.startswith("fit.")} == \
        {k: v for k, v in counters.items() if k.startswith("fit.")}
    assert fit.state.step == 1
