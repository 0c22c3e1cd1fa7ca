"""On the card: the program's frames against the reference stay within the
cell's limit, and the control (the reference held in bfloat16 between steps)
does not, on full-size sphere frames at the scene's pose and at a swept one.
The readings the limits were set from come from ``benchmark/tools/readings.py``
at the cells' own sizes; this is its check at a size a test run holds."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from benchmark.harness import cell, check, meshes, runner
from benchmark.reference.frame import Reference, frame_keys


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3, 2**31 + 17, 2**32 - 3])
def test_program_within_the_limit_and_control_outside_it(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the program's kernels run on the card")
    conf = cell.config("sphere")
    acq = conf["acquisition"]
    mesh_dir = meshes.ensure(conf["meshes"], os.path.join(runner.MESH_ROOT, conf["name"]))
    scene = os.path.join(cell.ROOT, conf["scene"])
    sim = runner.simulator(conf, acq, scene, mesh_dir, seed, "cuda")
    ref = Reference(acq, scene, mesh_dir, seed, "cuda")
    pos = sim.position.cpu().numpy() + np.float32([[0, 0, 0], [0, 0, 1.4]])
    ang = np.broadcast_to(sim.angles.cpu().numpy(), pos.shape).copy()
    seeds = [seed, seed + 1]
    program = sim.render_frames(seeds, positions=pos, angles=ang)["bmode"]
    keys = frame_keys(seeds)
    reference = ref.render(keys, pos, ang)["bmode"]
    control = ref.render(keys, pos, ang, control=True)["bmode"]
    limit = cell.limits("sphere.chained")["rel_l2_max"]
    assert max(check.rel_l2(program, reference)) <= limit
    assert min(check.rel_l2(control, reference)) > limit
