"""The bounce physics as one kernel a bounce (``csrc/bounce.cu``).

Replaces no TPU kernel: the reference traces in jnp
(``mcray_tpu/models/simulator.py:trace_paths``, ``ops/physics.py``), which XLA
fuses. The plain version is the port's own composition: ``rays_plain`` (a
bounce's closest-hit query from the path state) and ``bounce_plain`` (what
a path does after its closest hit: the fuzz, the travel, ``hit_boundary``,
the segment and the next state), ~300 elementwise launches a bounce on the
card. ``bounce_physics_kernel`` runs both in one launch a bounce, one thread a
path, and writes the segments straight into the trace's (D + 1, N, ...)
record, bit for bit the plain version (the source's note has the layout and
the bound).

``Bounces`` runs the D bounces of a trace around its closest hits, one
launch at a time: the kernel for CUDA tensors, the plain version for CPU
tensors, which it writes into the same record. Each launch is an
``autograd.Function`` whose backward is autograd over the plain version,
rerun on the launch's inputs (rematerialised: the record holds the state
each bounce started from), so a gradient through the trace (the material
fit, the pose fit by autograd) takes the kernel's forward too. ``launch_counts()["bounce"]``
counts the kernel's launches: D + 1 a trace (row 0, then one a bounce).
"""

from __future__ import annotations

import ctypes

import torch

from ...config import SimConfig
from .. import physics
from ..geometry import distance_in_mm
from ..texture import fdiv
from . import _build
from .draws import FIELDS


#: the segment fields of a trace, in the order ``trace_paths`` returns them
SEGMENT_FIELDS = ("from", "to", "direction", "reflected", "initial", "attenuation", "distance",
                  "media_id", "valid", "rays")
#: the path state a bounce starts from
STATE_FIELDS = ("src", "direction", "media_id", "media_outside_id", "intensity", "distance_mm",
                "alive")
#: the fields of a record row that carry a gradient: the state, then the
#: query (attenuation, far end ``to``, and ``query``: (origin, segment))
GRADED_ROW = ("from", "direction", "initial", "distance", "attenuation", "to", "query")

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _Args(ctypes.Structure):
    """``McrayBounceArgs`` of ``csrc/bounce.cu``, field for field."""
    _fields_ = [
        ("positions", P), ("directions", P), ("local_samples", I), ("starting_material", I),
        ("initial_intensity", F),
        ("hit", P), ("point", P), ("normal", P), ("mesh_id", P),
        *((name, P) for name in FIELDS),
        ("materials", P), ("n_materials", I), ("mesh_inside", P), ("mesh_outside", P),
        ("mesh_vascular", P), ("n_mesh", I), ("spacing", P),
        ("from_", P), ("to", P), ("direction", P), ("reflected", P), ("initial", P),
        ("attenuation", P), ("distance", P), ("media_id", P), ("valid", P), ("outside", P),
        ("query", P),
        ("eps", F), ("eps_floor", F), ("frequency", F), ("ray_start_offset", F),
        ("speed_of_sound", F), ("max_travel_time_us", F),
        ("bug_compat_material_transition", I), ("cull_time_window", I),
        ("n", I), ("depth", I), ("first", I),
    ]


def initial_state(positions, directions, local_samples: int, starting_material: int,
                  cfg: SimConfig) -> dict:
    """The path state of bounce 0: path i at ``positions[i //
    local_samples]`` along ``directions[i // local_samples]``, in
    ``starting_material``, with ``cfg.initial_intensity / samples_per_element``."""
    n = positions.shape[0] * local_samples
    device = positions.device
    return {
        "src": positions.repeat_interleave(local_samples, dim=0),
        "direction": directions.repeat_interleave(local_samples, dim=0),
        "media_id": torch.full((n,), starting_material, dtype=torch.int32, device=device),
        "media_outside_id": torch.full((n,), -1, dtype=torch.int32, device=device),
        "intensity": torch.full((n,), cfg.initial_intensity / cfg.samples_per_element,
                                dtype=torch.float32, device=device),
        "distance_mm": torch.zeros((n,), dtype=torch.float32, device=device),
        "alive": torch.ones((n,), dtype=torch.bool, device=device),
    }


def thickness_by_mesh(materials, scene: dict):
    """Each mesh's inside thickness, so the per-ray lookup is one small gather."""
    return physics.take_rows(materials, scene["mesh_mat_inside"])[:, physics.THICKNESS]


def rays_plain(state: dict, materials, spacing, cfg: SimConfig) -> dict:
    """A bounce's closest-hit query from the path ``state``: the medium's
    ``attenuation``, the far end ``dest`` of the attenuation-bounded reach,
    and the ray as the closest hit takes it, ``origin`` (parked far away on
    a dead path) and ``seg_vec`` (zero on a dead path: it hits nothing)."""
    src, direction, alive = state["src"], state["direction"], state["alive"]
    eps = cfg.intensity_epsilon
    att = physics.take_rows(materials[:, physics.ATTENUATION], state["media_id"])
    r_length = physics.max_ray_length(torch.clamp(state["intensity"], min=eps * 1e-3), att,
                                      cfg.transducer_frequency, eps)
    origin = src + cfg.ray_start_offset * direction
    # enlarge(): mm/100 with per-axis spacing (src/scene.cpp:292-298).
    # r_length is detached: it only sets the ray's reach (hit or no hit);
    # the hit point does not move with the segment's scale, so its
    # analytic gradient is zero, but in f32 it is a cancellation of huge
    # log(eps/I)/att^2 terms that would pour noise into the material
    # gradients (as the reference, models/simulator.py:136-143)
    dest = src + fdiv(r_length.detach()[:, None], 100.0) * spacing * direction
    # dead rays get a zero segment parked far away: det == 0, so they miss
    alive_col = alive[:, None]
    seg_vec = (dest - origin) * alive_col
    origin = torch.where(alive_col, origin, 1e9)
    return {"attenuation": att, "dest": dest, "origin": origin, "seg_vec": seg_vec}


def bounce_plain(hits: dict, draws: dict, state: dict, query: dict, materials, thick_by_mesh,
                 scene: dict, spacing, cfg: SimConfig) -> tuple[dict, dict]:
    """A bounce after its closest hit ``hits``, with the bounce's (N,)
    ``draws`` and ``query``'s ``attenuation`` and ``dest`` (``rays_plain``'s):
    the sub-surface fuzz, the travel to the hit, the boundary
    (``physics.hit_boundary``). Returns the bounce's segment (its ray is the
    query's) and the path state of the next bounce."""
    src, direction, intensity = state["src"], state["direction"], state["intensity"]
    distance_mm, media_id, alive = state["distance_mm"], state["media_id"], state["alive"]
    att, dest = query["attenuation"], query["dest"]
    eps = cfg.intensity_epsilon
    hit = hits["hit"] & alive

    # sub-surface penetration fuzz: q ~ |N(0, thickness_inside)| (src/scene.cpp:129-139)
    thick = physics.take_rows(thick_by_mesh, hits["mesh_id"].clamp(min=0))
    q = torch.abs(draws["q_normal"] * thick)
    inside_point = hits["point"] + q[:, None] * direction

    dist_mm = distance_in_mm(src, inside_point, spacing)
    intensity_travelled = intensity * physics.travel_attenuation(att, dist_mm,
                                                                 cfg.transducer_frequency)
    hb = physics.hit_boundary(
        direction, hits["point"], hits["normal"], intensity_travelled,
        media_id, state["media_outside_id"], hits["mesh_id"], materials,
        scene["mesh_mat_inside"], scene["mesh_mat_outside"], scene["mesh_is_vascular"], cfg,
        draws=draws,
    )
    miss = alive & ~hits["hit"]
    segment = {
        "from": src,
        "to": torch.where(hit[:, None], inside_point, dest),
        "direction": direction,
        "reflected": torch.where(hit, hb["back_intensity"], 0.0),
        "initial": intensity,
        "attenuation": att,
        "distance": distance_mm,
        "media_id": media_id,
        "valid": hit | miss,
    }

    alive_next = hit & (hb["new_intensity"] > eps)
    if cfg.cull_time_window:
        # the continuation's segment would start at t0 >= the window: none
        # of its echoes can land in the RF image
        t0_next = fdiv((distance_mm + dist_mm) * 1000.0, cfg.speed_of_sound)
        alive_next = alive_next & (t0_next < float(cfg.max_travel_time_us))
    nxt = {
        "src": torch.where(hit[:, None], hb["new_from"], src),
        "direction": torch.where(hit[:, None], hb["new_direction"], direction),
        "media_id": torch.where(hit, hb["new_media_id"], media_id),
        "media_outside_id": torch.where(hit, hb["new_media_outside_id"],
                                        state["media_outside_id"]),
        "intensity": torch.where(hit, hb["new_intensity"], intensity),
        "distance_mm": torch.where(hit, distance_mm + dist_mm, distance_mm),
        "alive": alive_next,
    }
    return segment, nxt


def row_of(state: dict, query: dict) -> dict:
    """A record row from a path ``state`` and its ``rays_plain`` query."""
    return {"from": state["src"], "direction": state["direction"], "initial": state["intensity"],
            "distance": state["distance_mm"], "attenuation": query["attenuation"],
            "to": query["dest"], "query": torch.stack([query["origin"], query["seg_vec"]]),
            "media_id": state["media_id"], "outside": state["media_outside_id"],
            "valid": state["alive"]}


def state_of(row: dict) -> dict:
    """The path state a record row holds, by ``STATE_FIELDS``."""
    return {"src": row["from"], "direction": row["direction"], "media_id": row["media_id"],
            "media_outside_id": row["outside"], "intensity": row["initial"],
            "distance_mm": row["distance"], "alive": row["valid"]}


def row_as_query(row: dict) -> dict:
    """The query a record row holds, as ``rays_plain`` returns it."""
    return {"attenuation": row["attenuation"], "dest": row["to"], "origin": row["query"][0],
            "seg_vec": row["query"][1]}


class _Record:
    """A trace's (D + 1, N, ...) record and the launches that fill it: row
    d holds the state bounce d starts from and its closest-hit query (the
    fields of segment d but its end ``to`` and ``reflected``, which bounce d
    writes over the query's far end). ``start`` fills row 0 from the
    elements, ``bounce(d, ...)`` runs bounce d and fills row d + 1. On the
    card each is one kernel launch; on the CPU ``start_plain`` and
    ``bounce_plain`` compute them, written through ``.data`` as the kernel
    writes through a pointer, so no row handed to autograd sees its version
    move."""

    def __init__(self, positions, directions, local_samples: int, draws: dict, materials,
                 scene: dict, spacing, starting_material: int, cfg: SimConfig):
        self.cfg, self.scene, self.draws = cfg, scene, draws
        self.local_samples, self.starting_material = local_samples, starting_material
        n = positions.shape[0] * local_samples
        rows, device = cfg.max_depth + 1, positions.device
        f32 = dict(dtype=torch.float32, device=device)
        self.buffers = {
            "from": torch.empty((rows, n, 3), **f32),
            "to": torch.empty((rows, n, 3), **f32),
            "direction": torch.empty((rows, n, 3), **f32),
            "reflected": torch.empty((cfg.max_depth, n), **f32),
            "initial": torch.empty((rows, n), **f32),
            "attenuation": torch.empty((rows, n), **f32),
            "distance": torch.empty((rows, n), **f32),
            "media_id": torch.empty((rows, n), dtype=torch.int32, device=device),
            "valid": torch.empty((rows, n), dtype=torch.bool, device=device),
            "outside": torch.empty((rows, n), dtype=torch.int32, device=device),
            "query": torch.empty((rows, 2, n, 3), **f32),
        }
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"no bounce physics for tensors on {device}")
        self.raw = {k: v.data for k, v in self.buffers.items()}
        if self.card:
            self.args = self._args(positions, directions, materials, spacing, n)

    @property
    def card(self) -> bool:
        """Whether the kernel fills the record (CUDA tensors)."""
        return self.buffers["query"].is_cuda

    def row(self, d: int) -> dict:
        """Row ``d``'s views (``reflected`` on rows [0, D) only)."""
        return {k: v[d] for k, v in self.buffers.items() if k != "reflected" or d < len(v)}

    def _args(self, positions, directions, materials, spacing, n: int) -> _Args:
        """The launches' arguments, the inputs checked and held for the
        trace's length."""
        cfg, scene = self.cfg, self.scene
        self.inputs = [positions.contiguous(), directions.contiguous(), materials.contiguous(),
                       spacing.contiguous(), *(self.draws[k].contiguous() for k in FIELDS)]
        positions, directions, materials, spacing, *fields = self.inputs
        r = positions.shape[0]
        _build.require(positions, "positions", torch.float32, (r, 3))
        _build.require(directions, "directions", torch.float32, (r, 3))
        _build.require(materials, "materials", torch.float32, (materials.shape[0], 8))
        _build.require(spacing, "spacing", torch.float32, (3,))
        for name, field in zip(FIELDS, fields):
            _build.require(field, name, torch.float32, (cfg.max_depth, n))
        n_mesh = scene["mesh_mat_inside"].shape[0]
        _build.require(scene["mesh_mat_inside"], "mesh_mat_inside", torch.int32, (n_mesh,))
        _build.require(scene["mesh_mat_outside"], "mesh_mat_outside", torch.int32, (n_mesh,))
        _build.require(scene["mesh_is_vascular"], "mesh_is_vascular", torch.bool, (n_mesh,))
        shared = _build.library().mcray_bounce_shared_bytes(materials.shape[0], n_mesh)
        if shared > _build.SHARED_BYTES:
            raise ValueError(f"{materials.shape[0]} materials and {n_mesh} meshes take {shared} "
                             f"bytes of shared memory, more than {_build.SHARED_BYTES}")
        b = self.buffers
        return _Args(
            positions=positions.data_ptr(), directions=directions.data_ptr(),
            local_samples=self.local_samples, starting_material=self.starting_material,
            initial_intensity=cfg.initial_intensity / cfg.samples_per_element,
            **{name: f.data_ptr() for name, f in zip(FIELDS, fields)},
            materials=materials.data_ptr(), n_materials=materials.shape[0],
            mesh_inside=scene["mesh_mat_inside"].data_ptr(),
            mesh_outside=scene["mesh_mat_outside"].data_ptr(),
            mesh_vascular=scene["mesh_is_vascular"].data_ptr(), n_mesh=n_mesh,
            spacing=spacing.data_ptr(),
            from_=b["from"].data_ptr(), to=b["to"].data_ptr(), direction=b["direction"].data_ptr(),
            reflected=b["reflected"].data_ptr(), initial=b["initial"].data_ptr(),
            attenuation=b["attenuation"].data_ptr(), distance=b["distance"].data_ptr(),
            media_id=b["media_id"].data_ptr(), valid=b["valid"].data_ptr(),
            outside=b["outside"].data_ptr(), query=b["query"].data_ptr(),
            eps=cfg.intensity_epsilon, eps_floor=cfg.intensity_epsilon * 1e-3,
            frequency=cfg.transducer_frequency, ray_start_offset=cfg.ray_start_offset,
            speed_of_sound=cfg.speed_of_sound, max_travel_time_us=cfg.max_travel_time_us,
            bug_compat_material_transition=int(cfg.bug_compat_material_transition),
            cull_time_window=int(cfg.cull_time_window), n=n, depth=0, first=1,
        )

    def _launch(self) -> None:
        _build.launch("mcray_bounce", ctypes.byref(self.args), device=self.buffers["query"].device)

    def _write(self, d: int, row: dict) -> None:
        for k, v in row.items():
            self.raw[k][d].copy_(v)

    def start_plain(self, positions, directions, materials, spacing) -> dict:
        """Row 0 by the plain version."""
        state = initial_state(positions, directions, self.local_samples, self.starting_material,
                              self.cfg)
        return row_of(state, rays_plain(state, materials, spacing, self.cfg))

    def start(self, positions, directions, materials, spacing) -> None:
        if not self.card:
            return self._write(0, self.start_plain(positions, directions, materials, spacing))
        self.args.first = 1
        self._launch()

    def bounce_plain(self, d: int, row: dict, hits: dict, materials, spacing) -> tuple:
        """Bounce ``d`` from its ``row`` by the plain version: the segment's
        ``to`` and ``reflected``, and row d + 1."""
        draws = {k: v[d] for k, v in self.draws.items()}
        segment, nxt = bounce_plain(hits, draws, state_of(row), row_as_query(row), materials,
                                    thickness_by_mesh(materials, self.scene), self.scene,
                                    spacing, self.cfg)
        return segment["to"], segment["reflected"], row_of(nxt, rays_plain(nxt, materials,
                                                                           spacing, self.cfg))

    def bounce(self, d: int, row: dict, hits: dict, materials, spacing) -> None:
        if not self.card:
            to, reflected, nxt = self.bounce_plain(d, row, hits, materials, spacing)
            self._write(d, {"to": to, "reflected": reflected})
            return self._write(d + 1, nxt)
        n = self.args.n
        hit, point = hits["hit"].contiguous(), hits["point"].contiguous()
        normal, mesh_id = hits["normal"].contiguous(), hits["mesh_id"].contiguous()
        _build.require(hit, "hit", torch.bool, (n,))
        _build.require(point, "point", torch.float32, (n, 3))
        _build.require(normal, "normal", torch.float32, (n, 3))
        _build.require(mesh_id, "mesh_id", torch.int32, (n,))
        self.hits = (hit, point, normal, mesh_id)  # held until the launch has read them
        self.args.hit, self.args.point = hit.data_ptr(), point.data_ptr()
        self.args.normal, self.args.mesh_id = normal.data_ptr(), mesh_id.data_ptr()
        self.args.depth, self.args.first = d, 0
        self._launch()


def _plain_grads(ctx, run, inputs, grads) -> list:
    """A launch's backward: autograd over ``run``, the plain version of the
    launch, rerun on leaves of its ``inputs``; the gradient of each input
    that needs one, None for the rest."""
    leaves = [t.detach().requires_grad_(need) if need else t.detach()
              for t, need in zip(inputs, ctx.needs_input_grad[-len(inputs):])]
    with torch.enable_grad():
        outs = run(*leaves)
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
    wanted = [t for t in leaves if t.requires_grad]
    if not pairs or not wanted:
        return [None] * len(inputs)
    got = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs],
                                   allow_unused=True))
    return [next(got) if t.requires_grad else None for t in leaves]


class _Start(torch.autograd.Function):
    """Row 0 from the elements: its ``GRADED_ROW`` fields, views of the record."""

    @staticmethod
    def forward(ctx, record, positions, directions, materials, spacing):
        ctx.set_materialize_grads(False)
        record.start(positions, directions, materials, spacing)
        ctx.record = record
        ctx.save_for_backward(positions, directions, materials, spacing)
        row = record.row(0)
        ctx.mark_non_differentiable(row["initial"], row["distance"])
        return tuple(row[k] for k in GRADED_ROW)

    @staticmethod
    def backward(ctx, *grads):
        record = ctx.record

        def run(*inputs):
            row = record.start_plain(*inputs)
            return tuple(row[k] for k in GRADED_ROW)

        return (None, *_plain_grads(ctx, run, ctx.saved_tensors, grads))


class _Bounce(torch.autograd.Function):
    """Bounce d after its closest hit: segment d's ``to`` and ``reflected``,
    then row d + 1's ``GRADED_ROW`` fields, views of the record. ``to``
    (row d's far end, an input) is the one field a launch writes over:
    its value only enters ``where(hit, inside point, far end)``, so the
    backward's rerun takes the row as it holds it after the launch."""

    @staticmethod
    def forward(ctx, record, d, ints, hit, mesh_id, *tensors):
        ctx.set_materialize_grads(False)
        *graded, point, normal, materials, spacing = tensors
        row = {**dict(zip(GRADED_ROW, graded)), **ints}
        record.bounce(d, row, {"hit": hit, "point": point, "normal": normal, "mesh_id": mesh_id},
                      materials, spacing)
        ctx.record, ctx.d, ctx.ints = record, d, ints
        ctx.save_for_backward(hit, mesh_id, *tensors)
        nxt = record.row(d + 1)
        return (record.buffers["to"][d], record.buffers["reflected"][d],
                *(nxt[k] for k in GRADED_ROW))

    @staticmethod
    def backward(ctx, *grads):
        record, d, ints = ctx.record, ctx.d, ctx.ints
        hit, mesh_id, *tensors = ctx.saved_tensors

        def run(*inputs):
            *graded, point, normal, materials, spacing = inputs
            row = {**dict(zip(GRADED_ROW, graded)), **ints}
            hits = {"hit": hit, "point": point, "normal": normal, "mesh_id": mesh_id}
            to, reflected, nxt = record.bounce_plain(d, row, hits, materials, spacing)
            return (to, reflected, *(nxt[k] for k in GRADED_ROW))

        return (None, None, None, None, None, *_plain_grads(ctx, run, tensors, grads))


class Bounces:
    """The D bounces of one trace around its closest hits. ``query`` is
    the current bounce's ray, ``(origin, seg_vec)`` (N, 3) each; ``step(hits)``
    runs the bounce after its closest hit and sets up the next query;
    ``segments()`` returns the (D, N, ...) segment fields and
    ``final_state()`` the path state after the last step (the state a bounce
    D would start from).

    The paths start at their elements (``initial_state``). The record lives
    in (D + 1, N, ...) buffers that each launch fills a row of: one launch
    writes row 0 here, each ``step`` one more. ``segments()`` returns views of
    rows [0, D), or, where a gradient is recorded, the launches' rows
    stacked (the same values, each with its launch's backward)."""

    def __init__(self, positions, directions, local_samples: int, draws: dict, materials,
                 scene: dict, spacing, starting_material: int, cfg: SimConfig):
        self.cfg, self.d = cfg, 0
        self.materials, self.spacing = materials, spacing
        self.record = _Record(positions, directions, local_samples, draws, materials, scene,
                              spacing, starting_material, cfg)
        graded = _Start.apply(self.record, positions, directions, materials, spacing)
        self.rows = [{**self.record.row(0), **dict(zip(GRADED_ROW, graded))}]

    @property
    def query(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The current bounce's closest-hit query (origin, seg_vec), (N, 3) each."""
        query = self.rows[self.d]["query"]
        return query[0], query[1]

    def step(self, hits: dict) -> None:
        """The current bounce after its closest hit ``hits`` (``hit``,
        ``point``, ``normal``, ``mesh_id``); then the next bounce's query."""
        d = self.d
        if d >= self.cfg.max_depth:
            raise ValueError(f"all {self.cfg.max_depth} bounces have run")
        row = self.rows[d]
        ints = {k: row[k] for k in ("media_id", "outside", "valid")}
        out = _Bounce.apply(self.record, d, ints, hits["hit"], hits["mesh_id"],
                            *(row[k] for k in GRADED_ROW), hits["point"], hits["normal"],
                            self.materials, self.spacing)
        row["to"], row["reflected"] = out[0], out[1]
        self.rows.append({**self.record.row(d + 1), **dict(zip(GRADED_ROW, out[2:]))})
        self.d += 1

    def segments(self) -> dict[str, torch.Tensor]:
        """The (D, N, ...) segment fields (``rays`` (D, 6, N)), once every
        bounce has run."""
        d = self.cfg.max_depth
        if self.d != d:
            raise ValueError(f"{self.d} of {d} bounces have run")
        rows = self.rows[:d]
        graded = any(r[k].requires_grad for r in rows for k in (*GRADED_ROW, "reflected"))
        out = {}
        for k in (*SEGMENT_FIELDS[:-1], "query"):
            stack = graded and k not in ("media_id", "valid")
            out[k] = torch.stack([r[k] for r in rows]) if stack else self.record.buffers[k][:d]
        # (D, 2, N, 3) -> (D, 6, N): [origin; segment] as the closest hit takes its rays
        out["rays"] = out.pop("query").transpose(2, 3).reshape(d, 6, -1)
        return out

    def final_state(self) -> dict[str, torch.Tensor]:
        """The path state after the last step, by ``STATE_FIELDS``."""
        return state_of(self.rows[self.d])
