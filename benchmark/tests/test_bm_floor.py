"""The frozen floor arithmetic counts what the port's ``roofline.frame_costs``
counts, stage by stage, operation for operation and byte for byte, on
``small_test_config()`` frames; the frozen kernel-name table is the port's."""

from __future__ import annotations

import pytest

from benchmark.harness import roofline as frozen
from benchmark.tests.helpers import setup
from mcray_tpu_torch.utils import roofline


@pytest.mark.parametrize("seeds", [[7], [11, 12]], ids=["frame", "batch"])
def test_the_frozen_floor_is_frame_costs(seeds):
    acq, sim, ref = setup("sphere")
    out = sim.render_frames(seeds)
    s = ref.scene
    tree = frozen.Tree(s.bvh_nodes, s.bvh_meta, s.bvh_order, s.tris, "cpu")
    mine = frozen.stage_costs(out["segments"], tree, acq)
    port = roofline.frame_costs(sim, out)
    assert set(mine) == set(port)
    for stage, cost in port.items():
        assert mine[stage] == (cost.hbm_bytes, cost.flops), stage
    floor = sum(c.floor()[0] for c in port.values()) / len(seeds)
    assert frozen.frame_floor_ms(out["segments"], tree, acq) == pytest.approx(floor, rel=1e-12)


def test_the_peaks_and_the_kernel_names_are_the_ports():
    assert frozen.EVENT_NAMES == roofline.EVENT_NAMES
    assert (frozen.PEAK_BYTES_PER_S, frozen.PEAK_F32_OPS_PER_S) == (
        roofline.PEAK_BYTES_PER_S, roofline.PEAK_F32_OPS_PER_S)
