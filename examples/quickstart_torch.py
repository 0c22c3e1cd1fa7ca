"""mcray_tpu_torch quickstart: render, compound, sweep, differentiate, shard.

The steps of ``examples/quickstart.py`` through the PyTorch port, on the
card (its CUDA kernels, built at first use) unless ``--device cpu`` asks for
the kernels' plain versions. Run from the repo root:

    python examples/quickstart_torch.py                # an NVIDIA GPU
    python examples/quickstart_torch.py --device cpu   # anywhere
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
import torch.distributed as dist

from mcray_tpu_torch.config import small_test_config
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.models.trainer import MaterialFitter
from mcray_tpu_torch.ops.physics import ATTENUATION
from mcray_tpu_torch.parallel.shard import ShardedRenderer, make_mesh
from mcray_tpu_torch.scene.compile import load_and_compile
from mcray_tpu_torch.utils.image_io import save_png


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "quickstart_torch.png"))
    args = ap.parse_args(argv)
    cfg = small_test_config(transducer_elements=64, samples_per_element=2,
                            soft_scattering=True, trilinear_texture=True)

    # --- 1. load a reference-format .scene and render a B-mode frame -------
    pack = load_and_compile("assets/sphere/sphere.scene")
    sim = Simulator(pack, cfg, device=args.device)
    out = sim.render_frame(seed=0)
    save_png(args.out, out["bmode"].cpu().numpy())
    print("rendered", tuple(out["bmode"].shape), "on", sim.device, "->", args.out)

    # --- 2. Monte-Carlo compounding: the mean of independent frames --------
    compound = sim.render_compound(range(4))
    print("compound frame max:", float(compound.max()))

    # --- 3. probe sweep: the pose is an argument of the frame --------------
    for dy in (0.0, 0.5):
        sim.render_frame(seed=0, position=sim.position + torch.tensor([0.0, dy, 0.0],
                                                                      device=sim.device))
    print("swept 2 poses")

    # --- 4. differentiable fit: recover a perturbed material parameter -----
    draws = sim.draws(0)  # one fixed speckle realisation for target and fit
    with torch.no_grad():
        target = sim.render_frame(draws=draws)["bmode"]
    liver = 3
    start = pack.materials.copy()
    start[liver, ATTENUATION] *= 2.0
    fitter = MaterialFitter.from_simulator(sim, start, target, learning_rate=5e-2,
                                           trainable=(ATTENUATION,), trainable_rows=[liver],
                                           fixed_frame=draws)
    fitter.run(10, verbose=False)
    print(f"fit LIVER attenuation: start {start[liver, ATTENUATION]:.3f} -> "
          f"{float(fitter.state.materials[liver, ATTENUATION]):.3f} "
          f"(true {pack.materials[liver, ATTENUATION]:.3f})")

    # --- 5. scanline-sharded render on a one-rank group (NCCL on the card) --
    # More ranks: start one process per GPU with torchrun (or call
    # parallel.multihost.initialize) and build the mesh the same way.
    try:
        sharded = ShardedRenderer(pack, cfg, make_mesh(device=args.device))
        frame = sharded.render_frame(seed=0)
        print(f"sharded render ({dist.get_backend()}, {dist.get_world_size()} rank): RF equal "
              f"{torch.equal(frame['rf_raw'], out['rf_raw'])}, B-mode max |diff| "
              f"{float((frame['bmode'] - out['bmode']).abs().max()):.3g}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
