"""One rank of a gloo run of the port's parallel layer on the CPU.

    python tests/torch_shard_worker.py <case> <rank> <world> <port> <out_dir>

Imports only ``torch`` and ``mcray_tpu_torch`` (no JAX: the tests that
spawn it compare its results with the reference in their own process).
Each rank joins the group through ``multihost.initialize`` at
``127.0.0.1:<port>`` and writes what it computed to
``<out_dir>/rank<rank>.npz``. Cases:

- ``frames`` (``small_test_config()``, the sphere): the sharded frames of
  seeds 0 and 2 in halo and gathered mode; at world 2 also one train step
  at the fit set-up (soft + trilinear, LIVER's attenuation doubled, that
  entry alone trainable); at world 4 also the 2 x 2 mesh's frame of seed
  0, the halo convolution's backward on a seeded image and cotangent, and
  the uneven and centered-PSF configurations, which must raise;
- ``conv``: ``convolve_psf_sharded`` on a seeded 465 x 64 image and
  ``convolve_psf_rows_sharded`` on 64 x 32 and 16 x 32 images;
- ``multihost``: ``global_mesh``, ``is_primary`` and the sharded frame of
  seed 0 against this process's own ``Simulator``, then one train step.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SPHERE_SCENE = os.path.join(ROOT, "assets", "sphere", "sphere.scene")
FIT_ROW, FIT_COL = 3, 1      # LIVER, physics.ATTENUATION
FIT_LR = 1e-2
ROWS_SHARDED = (64, 16)


def conv_inputs() -> dict[str, np.ndarray]:
    """The seeded images (and the halo backward's cotangent) the ``conv``
    and ``frames`` cases convolve; the tests make the same."""
    rng = np.random.default_rng(7)
    out = {"cols": rng.standard_normal((465, 64)).astype(np.float32),
           "grad_image": rng.standard_normal((465, 64)).astype(np.float32),
           "grad_cotangent": rng.standard_normal((465, 64)).astype(np.float32)}
    for rows in ROWS_SHARDED:
        out[f"rows{rows}"] = rng.standard_normal((rows, 32)).astype(np.float32)
    return out


def _raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def frames(rank: int, world: int) -> dict[str, np.ndarray]:
    from mcray_tpu_torch.config import small_test_config
    from mcray_tpu_torch.models.trainer import column_mask
    from mcray_tpu_torch.ops import imaging
    from mcray_tpu_torch.parallel import multihost
    from mcray_tpu_torch.parallel.shard import (ShardedRenderer, ShardedRenderer2D, make_mesh,
                                                make_mesh_2d)
    from mcray_tpu_torch.scene.compile import load_and_compile
    from mcray_tpu_torch.utils import rng

    cfg = small_test_config()
    pack = load_and_compile(SPHERE_SCENE)
    mesh = multihost.global_mesh(device="cpu")
    out = {}
    for mode, halo in (("halo", True), ("gathered", False)):
        renderer = ShardedRenderer(pack, cfg, mesh, distributed_imaging=halo)
        for seed in (0, 2):
            frame = renderer.render_frame(seed)
            out[f"{mode}{seed}_bmode"] = frame["bmode"].numpy()
            out[f"{mode}{seed}_rf_raw"] = frame["rf_raw"].numpy()
    if world == 2:
        fit_cfg = small_test_config(soft_scattering=True, trilinear_texture=True)
        renderer = ShardedRenderer(pack, fit_cfg, mesh)
        key = rng.fold_in(rng.prng_key(0), 0)
        with torch.no_grad():
            target = renderer.render_bmode(key)
        perturbed = renderer.materials.clone()
        perturbed[FIT_ROW, FIT_COL] *= 2.0
        mask = column_mask(perturbed.shape[0], (FIT_COL,), [FIT_ROW])
        step = renderer.make_train_step(FIT_LR, mask, perturbed)
        out["train_loss"] = np.float64(step(key, target))
        out["train_materials"] = step.materials.detach().numpy()
        out["train_grad"] = step.last_grad.numpy()
        out["train_target"] = target.numpy()
    if world == 4:
        r2d = ShardedRenderer2D(pack, cfg, make_mesh_2d(2, 2, device="cpu"))
        frame = r2d.render_frame(0)
        out["mesh2d_bmode"] = frame["bmode"].numpy()
        out["mesh2d_rf_raw"] = frame["rf_raw"].numpy()
        inputs = conv_inputs()
        c_local = inputs["grad_image"].shape[1] // world
        mine = slice(rank * c_local, (rank + 1) * c_local)
        image = torch.from_numpy(inputs["grad_image"][:, mine].copy()).requires_grad_(True)
        conv = imaging.convolve_psf_sharded(image, cfg, mesh.get_group())
        (conv * torch.from_numpy(inputs["grad_cotangent"][:, mine].copy())).sum().backward()
        out["halo_grad"] = image.grad.numpy()
        centered = dataclasses.replace(cfg, centered_psf=True)
        out["rejected"] = np.array([
            _raises(lambda: ShardedRenderer(pack, dataclasses.replace(cfg, transducer_elements=62),
                                            mesh)),
            _raises(lambda: ShardedRenderer2D(pack, dataclasses.replace(cfg, samples_per_element=3),
                                              make_mesh_2d(2, 2, device="cpu"))),
            _raises(lambda: ShardedRenderer(pack, centered, mesh)),
            _raises(lambda: ShardedRenderer2D(pack, centered, make_mesh_2d(2, 2, device="cpu"))),
            _raises(lambda: make_mesh(world + 1, device="cpu")),
        ])
        out["centered_gathered_bmode"] = ShardedRenderer(
            pack, centered, mesh, distributed_imaging=False).render_frame(0)["bmode"].numpy()
    return out


def conv(rank: int, world: int) -> dict[str, np.ndarray]:
    from mcray_tpu_torch.config import small_test_config
    from mcray_tpu_torch.ops import imaging
    from mcray_tpu_torch.parallel import multihost

    cfg = small_test_config()
    group = multihost.global_mesh(device="cpu").get_group()
    inputs = conv_inputs()
    out = {}
    c_local = inputs["cols"].shape[1] // world
    out["cols"] = imaging.convolve_psf_sharded(
        torch.from_numpy(inputs["cols"][:, rank * c_local:(rank + 1) * c_local].copy()), cfg,
        group).numpy()
    for rows in ROWS_SHARDED:
        r_local = rows // world
        out[f"rows{rows}"] = imaging.convolve_psf_rows_sharded(
            torch.from_numpy(inputs[f"rows{rows}"][rank * r_local:(rank + 1) * r_local].copy()),
            cfg, group).numpy()
    return out


def multihost_case(rank: int, world: int) -> dict[str, np.ndarray]:
    from mcray_tpu_torch.config import small_test_config
    from mcray_tpu_torch.models.simulator import Simulator
    from mcray_tpu_torch.parallel import multihost
    from mcray_tpu_torch.parallel.shard import ShardedRenderer
    from mcray_tpu_torch.scene.compile import load_and_compile
    from mcray_tpu_torch.utils import rng

    if torch.distributed.get_world_size() != world or multihost.is_primary() != (rank == 0):
        raise AssertionError(f"rank {rank}: world {torch.distributed.get_world_size()}, "
                             f"is_primary() {multihost.is_primary()}")
    cfg = small_test_config()
    pack = load_and_compile(SPHERE_SCENE)
    sharded = ShardedRenderer(pack, cfg, multihost.global_mesh(device="cpu"))
    frame = sharded.render_frame(0)
    single = Simulator(pack, cfg, device="cpu").render_frame(0)
    np.testing.assert_allclose(frame["bmode"].numpy(), single["bmode"].numpy(), rtol=1e-5,
                               atol=1e-6)
    c_local = cfg.transducer_elements // world
    np.testing.assert_array_equal(frame["rf_raw"].numpy(),
                                  single["rf_raw"][:, rank * c_local:(rank + 1) * c_local].numpy())
    step = sharded.make_train_step(1e-2)
    key = rng.fold_in(rng.prng_key(1), 0)
    loss = step(key, frame["bmode"])
    if not (np.isfinite(loss) and torch.isfinite(step.materials).all()
            and (step.materials.detach() != sharded.materials).any()):
        raise AssertionError(f"rank {rank}: the train step gave loss {loss} or left the materials")
    return {"bmode": frame["bmode"].numpy(), "loss": np.float64(loss)}


CASES = {"frames": frames, "conv": conv, "multihost": multihost_case}


def main(argv) -> int:
    case, rank, world, port, out_dir = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.set_num_threads(1)
    from mcray_tpu_torch.parallel import multihost

    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        out = CASES[case](rank, world)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
