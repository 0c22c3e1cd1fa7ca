"""What the CPU tests share: a configuration at ``small_test_config()``'s
sizes, with its meshes, its reference and the port's ``Simulator``."""

from __future__ import annotations

import functools
import os

from benchmark.harness import cell, meshes, runner
from benchmark.reference.frame import Reference

SMALL = dict(transducer_elements=64, samples_per_element=2, volume_size=32, bmode_rows=100,
             bmode_cols=125)


@functools.lru_cache(maxsize=None)
def setup(config: str, texture_seed: int = 1234):
    """(acquisition, the port's CPU ``Simulator``, the CPU ``Reference``)."""
    conf = cell.config(config)
    acq = {**conf["acquisition"], **SMALL}
    mesh_dir = meshes.ensure(conf["meshes"], os.path.join(runner.MESH_ROOT, conf["name"]))
    scene = os.path.join(cell.ROOT, conf["scene"])
    sim = runner.simulator(conf, acq, scene, mesh_dir, texture_seed, "cpu")
    return acq, sim, Reference(acq, scene, mesh_dir, texture_seed, "cpu")
