"""The plain reference of a frame: B-modes from frame keys and probe poses.

It imports nothing of the program: it reads the scene file and the meshes,
derives the texture seeds, the clusters and every frame's draws from the
same integers the program is given, and computes the frames in plain torch
on whatever device it is handed. ``control=True`` keeps every float state
between two steps (the draws, the ray state after each bounce, the segment
ends and echoes, the RF image, the envelope and the B-mode) in bfloat16, the
precision below the float32 that the configuration states.
"""

from __future__ import annotations

import torch

from . import imaging, rng, scene, trace

TEXTURE_KEY_XOR = 0x5CA77E7
LISTED_TILE_T, LISTED_TILE_R = 128, 512


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if x.is_floating_point() else x


class Reference:
    """The frames of one configuration: ``acquisition`` (the SimConfig
    fields the frame reads, by name), the scene file and its mesh
    directory, the texture seed, on ``device``."""

    def __init__(self, acquisition: dict, scene_path: str, mesh_dir: str, texture_seed: int,
                 device):
        p = dict(acquisition)
        for field, value in (("probe_type", "convex"), ("texture_mode", "procedural"),
                             ("scatter_rng", "bitsum"), ("envelope_mode", "reference"),
                             ("trilinear_texture", False), ("soft_scattering", False),
                             ("centered_psf", False), ("log_compression", False),
                             ("soft_row_binning", False), ("cull_time_window", True),
                             ("bug_compat_material_transition", False)):
            if p.get(field, value) != value:
                raise ValueError(f"the reference computes {field}={value!r} only")
        self.p, self.device = p, torch.device(device)
        self.scene = scene.load(scene_path, mesh_dir)
        self.clusters = scene.pack_clusters(self.scene, LISTED_TILE_T, self.device)
        self.texture(texture_seed)
        s = self.scene

        def tensor(a, dtype):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        self.tables = {"materials": tensor(s.materials, torch.float32),
                       "spacing": tensor(s.spacing, torch.float32),
                       "mesh_in": tensor(s.mesh_mat_inside, torch.int32),
                       "mesh_out": tensor(s.mesh_mat_outside, torch.int32),
                       "mesh_vasc": tensor(s.mesh_is_vascular, torch.bool),
                       "starting_material": int(s.starting_material)}
        self.scan_table = imaging.scan_table(p, self.device)

    def texture(self, texture_seed: int) -> None:
        """Take the scatterer field of ``texture_seed``: the two hash seeds
        ``randint(split(prng_key(seed ^ 0x5CA77E7))[0], (2,), 0, 2**31 - 1)``."""
        key = rng.prng_key(int(texture_seed) ^ TEXTURE_KEY_XOR)
        self.seeds = rng.randint(rng.split(key)[0], (2,), 0, 2**31 - 1).to(self.device)

    @property
    def position(self) -> torch.Tensor:
        return torch.as_tensor(self.scene.position, device=self.device)

    @property
    def angles(self) -> torch.Tensor:
        return torch.as_tensor(self.scene.angles, device=self.device)

    def render(self, frame_keys: torch.Tensor, positions=None, angles=None,
               control: bool = False, group=None) -> dict:
        """B frames of the (B, 2) ``frame_keys`` at the (B, 3) poses (the
        scene's by default). Returns ``bmode`` (B, H, W) and ``segments``.
        ``group``: rays of a packet that walk its cluster list on their own
        (None: the whole packet), a witness of the closest hit's grouping."""
        q = to_bf16 if control else None
        b = frame_keys.shape[0]
        positions = self.position.expand(b, 3) if positions is None else \
            torch.as_tensor(positions, dtype=torch.float32, device=self.device)
        angles = self.angles.expand(b, 3) if angles is None else \
            torch.as_tensor(angles, dtype=torch.float32, device=self.device)
        draws = trace.draws(frame_keys, self.p, self.device)
        if control:
            draws = {k: to_bf16(v) for k, v in draws.items()}
        with torch.no_grad():
            segments = trace.trace(draws, self.tables, positions, angles, self.p,
                                   self.clusters, LISTED_TILE_R, q, group)
            n_cols = b * self.p["transducer_elements"]
            wide = imaging.march(segments, self.tables["materials"], self.seeds, self.p, n_cols, q)
            rf_rows = imaging.derived(self.p)["rf_rows"]
            rf = wide.reshape(rf_rows, b, -1).transpose(0, 1).contiguous()
            env = imaging.envelope(imaging.convolve(rf, self.p))
            if control:
                env = to_bf16(env)
            bmode = torch.clamp(imaging.scan_convert(env, self.scan_table), min=0.0)
            if control:
                bmode = to_bf16(bmode)
        return {"bmode": bmode, "segments": segments}


def chained_keys(seed0: int, batch: int, step: int, device) -> torch.Tensor:
    """The (batch, 2) frame keys of step ``step`` of a chained call from
    ``seed0``: ``fold_in(prng_key(seed0), step * batch + b)``, the carry being
    0 for B-modes below 1e30."""
    offsets = step * batch + torch.arange(batch, dtype=torch.int64)
    return rng.fold_in(rng.prng_key(seed0), offsets).to(device)


def frame_keys(seeds) -> torch.Tensor:
    """The (B, 2) keys of integer frame seeds."""
    return torch.stack([rng.prng_key(s) for s in seeds])
