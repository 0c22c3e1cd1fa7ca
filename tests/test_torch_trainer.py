"""The material fit of the port against the reference's, on the CPU.

A 5-step Adam fit of the doubled LIVER attenuation at 32 elements x 2 paths
in soft + trilinear mode runs in both packages from the same draws (seed 1,
whose paths graze no triangle edge, so both packages trace the same paths),
the same target (the reference's frame) and the same start. Tolerances: each step's
loss rtol 1e-3, the fitted value atol 1e-4 (Adam's normalised update moves
the entry by ~lr per step whatever the gradient's size, so the value is
robust; the loss carries the frame's float differences). The rest checks
the port's own trainer: mask, clamp, several frames per step, checkpoints,
and the ``fit`` command.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (SPHERE_SCENE, both_configs, port_render_fn, reference_draws,
                         reference_render_fn, to_np)
from mcray_tpu.models.trainer import MaterialFitter as RefFitter
from mcray_tpu.scene.compile import load_and_compile as ref_load_and_compile
from mcray_tpu_torch import cli
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.models.trainer import DEFAULT_TRAINABLE, FitState, MaterialFitter, column_mask
from mcray_tpu_torch.ops import physics
from mcray_tpu_torch.scene.compile import load_and_compile
from mcray_tpu_torch.utils.checkpoint import load_fit_state, save_fit_state

ROW, COL = 3, physics.ATTENUATION  # LIVER, the sphere scene's box medium
FIT = dict(learning_rate=5e-2, trainable=(COL,), trainable_rows=[ROW])


def test_five_step_fit_matches_reference():
    seed = 1
    ref_cfg, cfg = both_configs(transducer_elements=32, samples_per_element=2,
                                soft_scattering=True, trilinear_texture=True)
    pack = ref_load_and_compile(SPHERE_SCENE, ref_cfg, with_bvh=False)
    n = cfg.transducer_elements * cfg.samples_per_element
    ref_render, seeds = reference_render_fn(ref_cfg, pack, seed)
    key = jax.random.PRNGKey(seed)
    target = np.asarray(ref_render(key, jnp.asarray(pack.materials)))
    start = pack.materials.copy()
    start[ROW, COL] *= 2.0

    ref_fit = RefFitter(ref_render, jnp.asarray(start), jnp.asarray(target), fixed_key=key, **FIT)
    want = ref_fit.run(5, verbose=False)
    fit = MaterialFitter(port_render_fn(cfg, pack, seeds, reference_draws(seed, n, cfg.max_depth)),
                         torch.from_numpy(start), torch.from_numpy(target.copy()), fixed_frame=0,
                         **FIT)
    got = fit.run(5, verbose=False)

    np.testing.assert_allclose(got, want, rtol=1e-3)
    fitted, ref_fitted = to_np(fit.state.materials), np.asarray(ref_fit.state.materials)
    np.testing.assert_allclose(fitted[ROW, COL], ref_fitted[ROW, COL], atol=1e-4)
    assert abs(fitted[ROW, COL] - start[ROW, COL]) > 0.1  # five steps of ~lr each
    # the mask leaves every untrained entry bitwise unchanged, in both
    untouched = np.ones_like(start, bool)
    untouched[ROW, COL] = False
    np.testing.assert_array_equal(fitted[untouched], start[untouched])
    np.testing.assert_array_equal(ref_fitted[untouched], start[untouched])
    assert fit.state.step == ref_fit.state.step == 5


@pytest.fixture(scope="module")
def small_sim():
    _, cfg = both_configs(transducer_elements=16, samples_per_element=2,
                          soft_scattering=True, trilinear_texture=True)
    pack = load_and_compile(SPHERE_SCENE)
    sim = Simulator(pack, cfg, device="cpu", seed=1)
    draws = sim.draws(1)
    with torch.no_grad():
        target = sim.render_frame(draws=draws)["bmode"]
    start = pack.materials.copy()
    start[ROW, COL] *= 2.0
    return sim, draws, target, start


def _fitter(small_sim, **kw):
    sim, draws, target, start = small_sim
    return MaterialFitter.from_simulator(sim, start, target, **{**FIT, "fixed_frame": draws, **kw})


def test_column_mask():
    mask = column_mask(5)
    assert mask.shape == (5, 8) and mask[:, list(DEFAULT_TRAINABLE)].all()
    assert float(mask.sum()) == 5 * len(DEFAULT_TRAINABLE)
    mask = column_mask(5, (COL,), [ROW])
    assert float(mask.sum()) == 1.0 and mask[ROW, COL] == 1.0


def test_fitter_lives_on_the_simulators_device(small_sim):
    fit = _fitter(small_sim)
    assert fit.device == small_sim[0].device == torch.device("cpu")
    assert fit.state.materials.device.type == "cpu" and fit.mask.device.type == "cpu"


def test_positivity_clamp_holds_on_trainable_entries_only(small_sim):
    """A huge learning rate drives the trained entry below zero: it is
    clamped to 1e-4, while untrained entries (GEL's 1e-8 attenuation, the
    zero thicknesses) stay as they are, below the clamp."""
    fit = _fitter(small_sim, learning_rate=100.0)
    fit.run(1, verbose=False)
    mats = to_np(fit.state.materials)
    assert mats[ROW, COL] == np.float32(1e-4)
    start = small_sim[3]
    assert (start < 1e-4).any()
    untouched = np.ones_like(start, bool)
    untouched[ROW, COL] = False
    np.testing.assert_array_equal(mats[untouched], start[untouched])
    assert float(fit.last_grad[ROW, COL]) != 0.0 and float(fit.last_grad.abs().sum()) == abs(
        float(fit.last_grad[ROW, COL]))


def test_several_frames_per_step(small_sim):
    fit = _fitter(small_sim, n_frames_per_step=2, fixed_frame=None)
    losses = fit.run(2, seed=7, verbose=False)
    assert len(losses) == 2 and all(np.isfinite(losses)) and fit.state.step == 2
    with pytest.raises(ValueError, match="integer frame seed"):
        _fitter(small_sim, n_frames_per_step=2).run(1, verbose=False)  # fixed draws: one frame


def test_checkpoint_resume_equals_a_straight_run(small_sim, tmp_path):
    """Five steps, a checkpoint, a sixth step: the fitter that went straight
    on and the one resumed from the file take the same sixth step, bitwise."""
    straight = _fitter(small_sim)
    want = straight.run(5, verbose=False)
    path = str(tmp_path / "fit.npz")
    save_fit_state(path, straight.state, extra={"note": 1})
    want += straight.run(1, verbose=False)

    resumed = _fitter(small_sim)
    resumed.state = load_fit_state(path, resumed.state)
    assert resumed.state.step == 5 and resumed.state.opt_state["step"] == 5
    got = resumed.run(1, verbose=False)

    assert got == want[5:] and resumed.state.step == straight.state.step == 6
    assert torch.equal(resumed.state.materials, straight.state.materials)
    for key in ("exp_avg", "exp_avg_sq"):
        assert torch.equal(resumed.state.opt_state[key], straight.state.opt_state[key])
    assert want[-1] < want[0]
    assert not (tmp_path / "fit.npz.tmp.npz").exists()  # written through a temporary file


def test_wrong_optimiser_state_raises(small_sim, tmp_path):
    fit = _fitter(small_sim)
    state = fit.state
    path = str(tmp_path / "fit.npz")
    other = FitState(state.materials[:4], {"exp_avg": state.opt_state["exp_avg"][:4],
                                           "exp_avg_sq": state.opt_state["exp_avg_sq"][:4],
                                           "step": 0}, 0)
    save_fit_state(path, other)
    with pytest.raises(ValueError, match="does not match"):
        load_fit_state(path, state)
    np.savez(path, materials=to_np(state.materials), step=np.asarray(0))  # no Adam state at all
    with pytest.raises(ValueError, match="does not match"):
        load_fit_state(path, state)
    with pytest.raises(ValueError, match="Adam state"):
        fit.state = FitState(state.materials, {"momentum": state.materials}, 0)


def test_fit_command_prints_the_json_line(tmp_path, capsys):
    ckpt = str(tmp_path / "fit.npz")
    argv = ["fit", SPHERE_SCENE, "--material", "LIVER", "--elements", "16", "--samples", "2",
            "--steps", "3", "--device", "cpu", "--checkpoint", ckpt]
    assert cli.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("LIVER.attenuation: true 0.7, start 1.4")
    summary = json.loads(lines[-2])
    assert set(summary) == {"param", "true", "initial", "fitted", "loss_first", "loss_last"}
    assert summary["param"] == "LIVER.attenuation" and summary["true"] == 0.7
    assert summary["initial"] == 1.4 and 1.2 < summary["fitted"] < 1.4
    assert lines[-1] == f"checkpoint -> {ckpt}"
    assert cli.main(argv[:-2] + ["--steps", "1", "--checkpoint", ckpt, "--resume"]) == 0
    assert "resumed at step 3" in capsys.readouterr().out


def test_default_device_is_the_card_and_raises_without_one():
    """No device named means the card; without one that raises and never
    carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    _, cfg = both_configs(transducer_elements=16, samples_per_element=2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Simulator(load_and_compile(SPHERE_SCENE), cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli.main([SPHERE_SCENE, "--elements", "16", "--samples", "2"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli.main(["fit", SPHERE_SCENE, "--material", "LIVER", "--elements", "16", "--steps", "1"])
