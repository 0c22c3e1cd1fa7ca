"""The port's parallel layer on the CPU: gloo ranks against one device and
against the reference's ``shard_map`` renderer.

Ranks are processes of ``tests/torch_shard_worker.py`` (torch and
``mcray_tpu_torch`` only, one thread each, a free port), spawned once per
world size for the whole module: 2 and 4 ranks render the sphere at
``small_test_config()`` (64 elements), 8 ranks run the halo convolutions.
While they run, this process computes the references: the port's
``Simulator`` on the CPU and the reference's ``ShardedRenderer`` over
``make_mesh(n)`` on the 8 virtual CPU devices of ``tests/conftest.py``.
Seeds 0 and 2 (seed 1 has an edge-grazing path, a reference-side defect in
``ROADMAP.md``).

Tolerances, set before the first run: the sharded frame's RF columns are
bitwise the single device's (each column is marched from the same paths,
drawn from the same global path ids, in the same order), its B-mode at
rtol 1e-5 / atol 1e-6 (the plain halo convolution against the plain
postproc, as ``tests/test_torch_postproc.py``) and at rtol 1e-4 / atol
1e-5 against the reference's sharded B-mode (``tests/test_sharding.py``);
the 2 x 2 mesh at rtol 1e-5 / atol 1e-6, since the sample groups' partial
images are summed in another order than one device sums them; the train
step's loss at rtol 1e-4 and its updated materials at 2e-6 against the
reference's step with ``optax.adam``, its gradient within 2e-3 of its
largest entry against one process's ``MaterialFitter`` (the ``all_reduce``
sums the ranks' partials in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_shard_worker as worker
from _torch_port import SPHERE_SCENE, both_configs, collect_ranks, spawn_ranks, to_np
from mcray_tpu.ops import imaging as ref_imaging
from mcray_tpu.parallel import shard as ref_shard
from mcray_tpu.scene.compile import load_and_compile as ref_load_and_compile
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.models.trainer import MaterialFitter
from mcray_tpu_torch.ops import imaging
from mcray_tpu_torch.parallel import shard
from mcray_tpu_torch.scene.compile import load_and_compile

SEEDS = (0, 2)
RUNS = {"frames2": ("frames", 2), "frames4": ("frames", 4), "conv8": ("conv", 8)}


def _reference_sharded_bmodes(pack, ref_cfg, world) -> dict[int, np.ndarray]:
    renderer = ref_shard.ShardedRenderer(pack, ref_cfg, mesh=ref_shard.make_mesh(world))
    # the port clamps the B-mode at 0, as the reference's kernel path does
    return {seed: np.maximum(np.asarray(renderer.render_frame(seed)["bmode"]), 0.0)
            for seed in SEEDS}


def _reference_train_step(pack, ref_fit_cfg) -> dict:
    """The reference's sharded step on ``make_mesh(2)`` at the fit set-up."""
    renderer = ref_shard.ShardedRenderer(pack, ref_fit_cfg, mesh=ref_shard.make_mesh(2))
    mask = np.zeros(pack.materials.shape, np.float32)
    mask[worker.FIT_ROW, worker.FIT_COL] = 1.0
    opt = optax.adam(worker.FIT_LR)
    step = renderer.make_train_step(opt, mask)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    pos, ang = jnp.asarray(pack.transducer_position), jnp.asarray(pack.transducer_angles)
    target = renderer.render_bmode(key, renderer.materials, pos, ang)
    start = renderer.materials.at[worker.FIT_ROW, worker.FIT_COL].multiply(2.0)
    materials, _, loss = step(key, start, opt.init(start), target, pos, ang)
    return {"loss": float(loss), "materials": np.asarray(materials)}


def _port_fitter_step(port_pack, fit_cfg) -> dict:
    """One single-process ``MaterialFitter`` step at the fit set-up."""
    sim = Simulator(port_pack, fit_cfg, device="cpu")
    draws = sim.draws(0)
    with torch.no_grad():
        target = sim.render_frame(draws=draws)["bmode"]
    start = sim.materials.clone()
    start[worker.FIT_ROW, worker.FIT_COL] *= 2.0
    fit = MaterialFitter.from_simulator(sim, start, target, learning_rate=worker.FIT_LR,
                                        trainable=(worker.FIT_COL,),
                                        trainable_rows=[worker.FIT_ROW], fixed_frame=draws)
    return {"loss": fit.step(draws), "grad": to_np(fit.last_grad)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workers' results by run, and the references computed meanwhile."""
    started = {}
    for name, (case, world) in RUNS.items():
        out_dir = tmp_path_factory.mktemp(name)
        started[name] = (spawn_ranks(case, world, out_dir), out_dir)
    try:
        ref_cfg, cfg = both_configs()
        ref_fit_cfg, fit_cfg = both_configs(soft_scattering=True, trilinear_texture=True)
        pack = ref_load_and_compile(SPHERE_SCENE, ref_cfg)
        port_pack = load_and_compile(SPHERE_SCENE)
        sim = Simulator(port_pack, cfg, device="cpu")
        refs = {
            "single": {seed: sim.render_frame(seed) for seed in SEEDS},
            "centered": Simulator(port_pack, dataclasses.replace(cfg, centered_psf=True),
                                  device="cpu").render_frame(0)["bmode"],
            "reference": {world: _reference_sharded_bmodes(pack, ref_cfg, world)
                          for world in (2, 4)},
            "reference_step": _reference_train_step(pack, ref_fit_cfg),
            "fitter_step": _port_fitter_step(port_pack, fit_cfg),
            "cfg": cfg,
            "fit_start": port_pack.materials.copy(),
        }
        refs["fit_start"][worker.FIT_ROW, worker.FIT_COL] *= 2.0
    finally:
        results = {}
        for name, (procs, out_dir) in started.items():
            results[name] = collect_ranks(procs, out_dir)
    return {**results, **refs}


def _columns(ranks, key) -> np.ndarray:
    return np.concatenate([r[key] for r in ranks], axis=1)


FRAME_CASES = [(world, mode, seed) for world in (2, 4) for mode in ("halo", "gathered")
               for seed in SEEDS]
FRAME_IDS = [f"world{w}-{m}-seed{s}" for w, m, s in FRAME_CASES]


@pytest.mark.parametrize("world,mode,seed", FRAME_CASES, ids=FRAME_IDS)
def test_sharded_rf_columns_equal_the_single_device_bitwise(runs, world, mode, seed):
    ranks = runs[f"frames{world}"]
    np.testing.assert_array_equal(_columns(ranks, f"{mode}{seed}_rf_raw"),
                                  to_np(runs["single"][seed]["rf_raw"]))


@pytest.mark.parametrize("world,mode,seed", FRAME_CASES, ids=FRAME_IDS)
def test_sharded_bmode_matches_the_single_device(runs, world, mode, seed):
    ranks = runs[f"frames{world}"]
    bmode = ranks[0][f"{mode}{seed}_bmode"]
    for r in ranks[1:]:  # replicated: every rank holds the same image
        np.testing.assert_array_equal(r[f"{mode}{seed}_bmode"], bmode)
    np.testing.assert_allclose(bmode, to_np(runs["single"][seed]["bmode"]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world,mode,seed", FRAME_CASES, ids=FRAME_IDS)
def test_sharded_bmode_matches_the_reference_sharded_renderer(runs, world, mode, seed):
    np.testing.assert_allclose(runs[f"frames{world}"][0][f"{mode}{seed}_bmode"],
                               runs["reference"][world][seed], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("seed", SEEDS)
def test_halo_imaging_matches_the_gathered_image(runs, world, seed):
    rank0 = runs[f"frames{world}"][0]
    np.testing.assert_allclose(rank0[f"halo{seed}_bmode"], rank0[f"gathered{seed}_bmode"],
                               rtol=1e-5, atol=1e-6)


def test_column_halo_convolution_across_several_ranks(runs):
    """64 columns over 8 ranks: 8 a rank, narrower than the 12-column halo."""
    cfg, image = runs["cfg"], worker.conv_inputs()["cols"]
    np.testing.assert_allclose(_columns(runs["conv8"], "cols"),
                               to_np(imaging.convolve_psf(torch.from_numpy(image), cfg)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rows", worker.ROWS_SHARDED)  # 16: 2 rows a rank, the halo 6
def test_row_halo_convolution(runs, rows):
    cfg, image = runs["cfg"], worker.conv_inputs()[f"rows{rows}"]
    got = np.concatenate([r[f"rows{rows}"] for r in runs["conv8"]], axis=0)
    np.testing.assert_allclose(got, to_np(imaging.convolve_psf(torch.from_numpy(image), cfg)),
                               rtol=1e-5, atol=1e-6)


def test_halo_backward_matches_autograd_of_the_convolution(runs):
    """World 4: the halo's gradient returns to its owner; every column,
    the boundary ones and those outside the write window included."""
    cfg, inputs = runs["cfg"], worker.conv_inputs()
    image = torch.from_numpy(inputs["grad_image"]).requires_grad_(True)
    (imaging.convolve_psf(image, cfg) * torch.from_numpy(inputs["grad_cotangent"])).sum().backward()
    np.testing.assert_allclose(_columns(runs["frames4"], "halo_grad"), to_np(image.grad),
                               rtol=1e-5, atol=1e-6)


def test_2d_mesh_matches_the_single_device(runs):
    """2 x 2 (rays x samples): rank (r, s) = 2 r + s; the RF columns of
    ranks 0 and 2 after the sample sum."""
    ranks, single = runs["frames4"], runs["single"][0]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["mesh2d_bmode"], ranks[0]["mesh2d_bmode"])
    np.testing.assert_array_equal(ranks[1]["mesh2d_rf_raw"], ranks[0]["mesh2d_rf_raw"])
    rf = np.concatenate([ranks[0]["mesh2d_rf_raw"], ranks[2]["mesh2d_rf_raw"]], axis=1)
    np.testing.assert_allclose(rf, to_np(single["rf_raw"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ranks[0]["mesh2d_bmode"], to_np(single["bmode"]),
                               rtol=1e-5, atol=1e-6)


def test_train_step_matches_the_reference_step(runs):
    got, want = runs["frames2"], runs["reference_step"]
    for r in got[1:]:
        np.testing.assert_array_equal(r["train_materials"], got[0]["train_materials"])
        assert float(r["train_loss"]) == float(got[0]["train_loss"])
    np.testing.assert_allclose(float(got[0]["train_loss"]), want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got[0]["train_materials"], want["materials"], rtol=0, atol=2e-6)
    # Adam's first step moves the one trainable entry by about the rate, and nothing else
    moved = got[0]["train_materials"] - runs["fit_start"]
    assert abs(abs(moved[worker.FIT_ROW, worker.FIT_COL]) - worker.FIT_LR) < 1e-5
    moved[worker.FIT_ROW, worker.FIT_COL] = 0.0
    assert not moved.any()


def test_train_step_gradient_matches_one_process(runs):
    got, want = runs["frames2"][0], runs["fitter_step"]
    grad = want["grad"]
    assert np.abs(grad).max() > 0
    np.testing.assert_allclose(got["train_grad"], grad, rtol=0, atol=2e-3 * np.abs(grad).max())
    np.testing.assert_allclose(float(got["train_loss"]), want["loss"], rtol=1e-4)


def test_uneven_meshes_and_the_centered_psf_under_the_halo_raise(runs):
    """World 4: 62 elements, 3 samples over 2, the centered PSF under the
    1-D and 2-D halo imaging, and a 5-device mesh all raise ValueError."""
    assert runs["frames4"][0]["rejected"].all(), runs["frames4"][0]["rejected"]


def test_gathered_mode_takes_the_centered_psf(runs):
    np.testing.assert_allclose(runs["frames4"][0]["centered_gathered_bmode"],
                               to_np(runs["centered"]), rtol=1e-5, atol=1e-6)


def test_centered_psf_parts_the_reference_halo_and_the_port_raises():
    """The reference's halo convolution applies the uncentered kernel under
    ``centered_psf`` and so parts from its own ``convolve_psf``; the port's
    raises."""
    from jax.sharding import Mesh, PartitionSpec as P

    ref_cfg, cfg = both_configs(centered_psf=True)
    image = worker.conv_inputs()["cols"]
    mesh = Mesh(np.asarray(jax.devices()), ("cols",))
    halo = jax.shard_map(
        lambda x: ref_imaging.convolve_psf_sharded(x, ref_cfg, "cols", 8), mesh=mesh,
        in_specs=P(None, "cols"), out_specs=P(None, "cols"), check_vma=False)(jnp.asarray(image))
    replicated = np.asarray(ref_imaging.convolve_psf(jnp.asarray(image), ref_cfg))
    assert not np.allclose(np.asarray(halo), replicated, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(to_np(imaging.convolve_psf(torch.from_numpy(image), cfg)),
                               replicated, rtol=1e-5, atol=1e-6)
    for fn in (imaging.convolve_psf_sharded, imaging.convolve_psf_rows_sharded):
        with pytest.raises(ValueError, match="centered_psf"):
            fn(torch.from_numpy(image), cfg)


def test_meshes_need_their_backend_and_their_world(monkeypatch):
    """No process group here: a mesh of two devices raises, and a cuda mesh
    raises without a card, or without NCCL (never gloo instead)."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        shard.make_mesh(2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA device"):
        shard.make_mesh(device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        shard.make_mesh_2d(1, 1, device="cuda")
    assert not torch.distributed.is_initialized()
