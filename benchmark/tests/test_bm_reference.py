"""The reference agrees with the port's CPU path (its plain versions of every
kernel) bit for bit, on ``small_test_config()`` frames.
Only this test imports the port beside the reference."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import frame as ref_frame
from benchmark.tests.helpers import setup
from mcray_tpu_torch.utils import rng


def test_frames_at_swept_poses_are_bitwise_the_ports():
    _, sim, ref = setup("sphere")
    seeds = [3, 2**32 - 5]
    pos = sim.position.numpy() + np.float32([[0, 0, 0], [0, 0, -0.6]])
    ang = np.broadcast_to(sim.angles.numpy(), pos.shape).copy()
    program = torch.cat([sim.render_frame(s, position=p, angles=a)["bmode"][None]
                         for s, p, a in zip(seeds, pos, ang)])
    reference = ref.render(ref_frame.frame_keys(seeds), pos, ang)["bmode"]
    assert torch.equal(program, reference)


def test_the_last_step_of_a_chained_call_is_bitwise_the_ports():
    _, sim, ref = setup("sphere")
    batch, n_chain, seed0 = 2, 2, 2**31 + 99
    program = sim.make_chained_batch(batch, n_chain)(seed0)
    keys = ref_frame.chained_keys(seed0, batch, n_chain - 1, "cpu")
    expect = rng.fold_in(rng.prng_key(seed0), (n_chain - 1) * batch + torch.arange(batch))
    assert torch.equal(keys, expect)
    assert torch.equal(program, ref.render(keys)["bmode"])


def test_the_texture_seeds_are_the_ports():
    _, sim, ref = setup("sphere")
    assert torch.equal(sim.seeds.to(torch.int64), ref.seeds.cpu())


def test_the_control_parts_from_the_reference():
    """Held in bfloat16 between steps, the frames part by far more than the
    limit (the readings on the card: 0.46-0.62 at full size)."""
    _, _, ref = setup("sphere")
    keys = ref_frame.frame_keys([5, 6])
    a, b = ref.render(keys)["bmode"], ref.render(keys, control=True)["bmode"]
    gap = (torch.linalg.vector_norm((a - b).flatten(1), dim=1)
           / torch.linalg.vector_norm(a.flatten(1), dim=1))
    assert (gap > 0.1).all()
