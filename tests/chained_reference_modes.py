"""Which seed0 can hold the port's ``make_chained_batch`` to the reference's.

Renders ``make_chained_batch(2, 2)`` of the sphere at 32 elements x 2 paths
for each seed0 in both packages, on the CPU, and prints the largest B-mode
difference of the port's frames (its default listed closest hit, and its
brute one) against the reference's jitted run and its run under
``jax.disable_jit()`` (every op rounded, as the port rounds it). A seed0
whose frames graze no edge and tie no hit agrees in all four.

    PYTHONPATH=. python tests/chained_reference_modes.py [seed0 ...]

(default seed0 0-7; about a minute a seed0 on one CPU thread, the first
op-by-op run the longest.)
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import conftest  # noqa: E402,F401  (JAX on the CPU)
import jax  # noqa: E402
import numpy as np  # noqa: E402

from _torch_port import SPHERE_SCENE, both_configs  # noqa: E402
from mcray_tpu.models.simulator import Simulator as RefSimulator  # noqa: E402
from mcray_tpu.scene.compile import load_and_compile as ref_load_and_compile  # noqa: E402
from mcray_tpu_torch.models.simulator import Simulator  # noqa: E402
from mcray_tpu_torch.scene.compile import load_and_compile  # noqa: E402


def main(seeds) -> None:
    ref_cfg, cfg = both_configs(transducer_elements=32, samples_per_element=2)
    ref = RefSimulator(ref_load_and_compile(SPHERE_SCENE, ref_cfg, with_bvh=False), ref_cfg,
                       seed=1).make_chained_batch(2, 2)
    port = {mode: Simulator(load_and_compile(SPHERE_SCENE), cfg, device="cpu", seed=1,
                            use_culled_intersect=mode == "listed").make_chained_batch(2, 2)
            for mode in ("listed", "brute")}
    for seed0 in seeds:
        want = {"jitted": np.maximum(np.asarray(ref(seed0)), 0.0)}
        with jax.disable_jit():
            want["op_by_op"] = np.maximum(np.asarray(ref(seed0)), 0.0)
        got = {mode: fn(seed0).numpy() for mode, fn in port.items()}
        diffs = {f"{mode}_vs_{kind}": float(np.abs(g - w).max())
                 for mode, g in got.items() for kind, w in want.items()}
        print(f"seed0 {seed0}: " + ", ".join(f"{k} {v:.8g}" for k, v in diffs.items()),
              flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or range(8))
