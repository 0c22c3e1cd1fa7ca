"""Scene runtime facade: the reference's ``scene`` class surface.

Port of ``mcray_tpu/scene/runtime.py`` (reference src/scene.h:19-76), so
that users of the C++ find its entry points:

- ``Scene(path, cfg, device=...)``  ~ scene::scene(json, transducer);
- ``.cast_rays(key, ...)``          ~ scene::cast_rays<S,R>(): the dense
  segment dict of ``models/simulator.py:trace_paths`` (each field (D, N, ...));
- ``.step(dt)``                     ~ scene::step, a no-op: meshes are static
  mass-0 bodies in the reference too (src/scene.cpp:326-330); the probe pose
  is the system's dynamic input, passed per call;
- ``.distance`` / ``.distance_in_mm`` / ``.enlarge``: the unit helpers
  (src/scene.cpp:281-298, :342-346), ``distance`` ignoring the spacing as
  the reference's does.

The tensors live on ``device``, the card unless the caller asks for the CPU
(without a card the default raises, as ``Simulator``'s does).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, SimConfig
from ..models import simulator
from ..utils import convert, rng
from .compile import ScenePack, load_and_compile
from .loader import SceneSpec, load_scene


class Scene:
    def __init__(self, scene_path: str, cfg: SimConfig = DEFAULT_CONFIG, *, device="cuda",
                 **compile_kw):
        self.cfg = cfg
        self.device = simulator.resolve_device(device)
        self.spec: SceneSpec = load_scene(scene_path)
        self.pack: ScenePack = load_and_compile(scene_path, **compile_kw)
        self._state = convert.from_reference(self.pack, self.pack.materials, np.zeros(2),
                                             device=self.device)

    # -- reference: scene::cast_rays (src/scene.cpp:50-183) -----------------
    def cast_rays(self, key, materials=None, position=None, angles=None,
                  **trace_kw) -> dict[str, torch.Tensor]:
        """Trace all elements x samples paths; returns the segment dict.
        ``key`` (an int seed or a (2,) key of ``utils/rng.py``) keys each
        path as ``fold_in(key, path id)``, as the reference's ``cast_rays``
        keys it; ``trace_kw`` (the closest-hit choice) go to ``trace_paths``,
        whose default is the brute kernel."""
        key = key if isinstance(key, torch.Tensor) else rng.prng_key(key)
        state = self._state

        def tensor(x, default):
            return default if x is None else torch.as_tensor(x, dtype=torch.float32,
                                                             device=self.device)

        return simulator.trace_paths(
            simulator.path_draws(key, self.cfg, self.device),
            tensor(materials, state["materials"]), tensor(position, state["position"]),
            tensor(angles, state["angles"]), state["scene"], state["spacing"],
            state["starting_material"], self.cfg, **trace_kw)

    # -- reference: scene::step (src/scene.cpp:336-339) ---------------------
    def step(self, delta_time: float) -> None:
        """No-op: the scene's meshes are static (mass-0), as in the reference;
        the probe pose is the dynamic input and is passed per call."""

    # -- reference unit helpers ---------------------------------------------
    def distance(self, a, b) -> float:
        """World distance x10 -> mm, ignoring spacing (src/scene.cpp:342-346)."""
        return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) * 10.0)

    def distance_in_mm(self, a, b) -> float:
        """World distance with per-axis spacing, x10 -> mm (src/scene.cpp:281-290)."""
        d = np.abs(np.asarray(a) - np.asarray(b)) * np.asarray(self.pack.spacing)
        return float(np.linalg.norm(d) * 10.0)

    def enlarge(self, versor, mm: float) -> np.ndarray:
        """mm -> world-units vector with per-axis spacing (src/scene.cpp:292-298)."""
        if not float(np.dot(versor, versor)) < 1.1:
            raise ValueError("enlarge: versor must be a unit vector")
        return mm / 100.0 * np.asarray(self.pack.spacing) * np.asarray(versor)

    @property
    def materials(self) -> np.ndarray:
        return self.pack.materials

    @property
    def n_triangles(self) -> int:
        return self.pack.n_triangles
