"""The bounce physics' wrapper (``ops/cuda/bounce.py``) on the CPU.

On CPU tensors ``Bounces`` fills its record by the plain version
(``rays_plain`` and ``bounce_plain``), launches nothing and counts nothing,
and ``trace_paths`` returns the segments of the loop it replaces bit for bit
(kept below as ``loop_trace``: the loop body as it ran inline, op for op),
with ``bug_compat_material_transition`` and ``cull_time_window`` on and off,
on a scene with vascular meshes and on a sharded subset of the elements. A
gradient through the launches (each backward the hand-derived adjoint,
``bounce_adjoint_plain`` / ``start_adjoint_plain``) is the loop's, into the
table and into the pose, and each launch's adjoint is autograd over the
plain version rerun on its inputs, on lanes placed on every hazard of the
derivation. The kernels are registered as ``bounce`` and ``bounce_bwd`` with
device event names that no frozen event name of the benchmark and no stage
mark shares, the backward adds without atomics and refuses a spacing
gradient, and the wrapper's argument blocks mirror the C structs field for
field. The kernels themselves are held to these plain versions on the card
(``tests/test_torch_cuda.py``).
"""

import dataclasses
import re
from pathlib import Path

import pytest
import torch

from _bounce_rerun import rerun_bounce_grads, rerun_grads, rerun_start
from _torch_port import SPHERE_SCENE
from mcray_tpu_torch.config import small_test_config
from mcray_tpu_torch.models import simulator
from mcray_tpu_torch.models.simulator import Simulator, cluster_intersect
from mcray_tpu_torch.ops import cuda as kernels
from mcray_tpu_torch.ops import physics
from mcray_tpu_torch.ops.cuda import bounce
from mcray_tpu_torch.ops.cuda.draws import fold_in
from mcray_tpu_torch.ops.cuda.intersect import intersect_closest_cuda
from mcray_tpu_torch.ops.geometry import safe_norm
from mcray_tpu_torch.ops.texture import fdiv
from mcray_tpu_torch.probe.transducer import element_layout
from mcray_tpu_torch.scene.compile import load_and_compile
from mcray_tpu_torch.utils import profiling, rng
from mcray_tpu_torch.utils.roofline import EVENT_NAMES

LIVER_SCENE = SPHERE_SCENE.replace("sphere/sphere.scene", "ircad11/santi-liver.scene")
CSRC = Path(bounce.__file__).resolve().parents[2] / "csrc"


def loop_trace(draws, materials, probe_position, probe_angles_deg, scene, spacing,
               starting_material, cfg, *, culled_tris=None, intersect_tile_r=128,
               elements=None):
    """``trace_paths`` as it was with the bounce physics inline (the cluster
    and brute closest hits), the oracle of the refactor, on any device."""
    n_samples = cfg.samples_per_element
    freq = cfg.transducer_frequency
    eps = cfg.intensity_epsilon
    if elements is None:
        positions, directions = element_layout(probe_position, probe_angles_deg, cfg)
        elem_idx = torch.arange(positions.shape[0], dtype=torch.int32,
                                device=positions.device).repeat_interleave(n_samples)
    else:
        positions, directions, elem_idx = elements
    n = elem_idx.shape[0]
    local_samples = n // positions.shape[0]
    tri_soa, tri_mesh_id = scene["tri_soa"], scene["tri_mesh_id"]
    mesh_in, mesh_out = scene["mesh_mat_inside"], scene["mesh_mat_outside"]
    mesh_vasc = scene["mesh_is_vascular"]
    thick_by_mesh = physics.take_rows(materials, mesh_in)[:, physics.THICKNESS]
    src = positions.repeat_interleave(local_samples, dim=0)
    direction = directions.repeat_interleave(local_samples, dim=0)
    on = {"device": positions.device}
    media_id = torch.full((n,), starting_material, dtype=torch.int32, **on)
    media_outside_id = torch.full((n,), -1, dtype=torch.int32, **on)
    intensity = torch.full((n,), cfg.initial_intensity / n_samples, dtype=torch.float32, **on)
    distance_mm = torch.zeros((n,), dtype=torch.float32, **on)
    alive = torch.ones((n,), dtype=torch.bool, **on)
    segments = []
    for d in range(cfg.max_depth):
        bounce_draws = {k: v[d] for k, v in draws.items()}
        att = physics.take_rows(materials[:, physics.ATTENUATION], media_id)
        r_length = physics.max_ray_length(torch.clamp(intensity, min=eps * 1e-3), att, freq, eps)
        origin = src + cfg.ray_start_offset * direction
        dest = src + fdiv(r_length.detach()[:, None], 100.0) * spacing * direction
        alive_col = alive[:, None]
        seg_vec = (dest - origin) * alive_col
        origin = torch.where(alive_col, origin, 1e9)
        if culled_tris is None:
            hits = intersect_closest_cuda(origin, seg_vec, tri_soa, tri_mesh_id)
        else:
            hits = cluster_intersect(culled_tris[1], intersect_tile_r)(origin, seg_vec,
                                                                       culled_tris[0])
        hit = hits["hit"] & alive
        thick = physics.take_rows(thick_by_mesh, hits["mesh_id"].clamp(min=0))
        q = torch.abs(bounce_draws["q_normal"] * thick)
        inside_point = hits["point"] + q[:, None] * direction
        dist_mm = safe_norm(torch.abs(src - inside_point) * spacing) * 10.0
        intensity_travelled = intensity * physics.travel_attenuation(att, dist_mm, freq)
        hb = physics.hit_boundary(direction, hits["point"], hits["normal"], intensity_travelled,
                                  media_id, media_outside_id, hits["mesh_id"], materials,
                                  mesh_in, mesh_out, mesh_vasc, cfg, draws=bounce_draws)
        miss = alive & ~hits["hit"]
        segments.append({
            "from": src, "to": torch.where(hit[:, None], inside_point, dest),
            "direction": direction, "reflected": torch.where(hit, hb["back_intensity"], 0.0),
            "initial": intensity, "attenuation": att, "distance": distance_mm,
            "media_id": media_id, "valid": hit | miss,
            "rays": torch.cat([origin, seg_vec], dim=1).T,
        })
        alive_next = hit & (hb["new_intensity"] > eps)
        if cfg.cull_time_window:
            t0_next = fdiv((distance_mm + dist_mm) * 1000.0, cfg.speed_of_sound)
            alive_next = alive_next & (t0_next < float(cfg.max_travel_time_us))
        src = torch.where(hit[:, None], hb["new_from"], src)
        direction = torch.where(hit[:, None], hb["new_direction"], direction)
        media_id = torch.where(hit, hb["new_media_id"], media_id)
        media_outside_id = torch.where(hit, hb["new_media_outside_id"], media_outside_id)
        intensity = torch.where(hit, hb["new_intensity"], intensity)
        distance_mm = torch.where(hit, distance_mm + dist_mm, distance_mm)
        alive = alive_next
    out = {k: torch.stack([s[k] for s in segments]) for k in segments[0]}
    out["element"] = elem_idx.expand(cfg.max_depth, n)
    return out


@pytest.fixture(scope="module")
def sphere():
    return load_and_compile(SPHERE_SCENE)


@pytest.fixture(scope="module")
def liver():
    return load_and_compile(LIVER_SCENE)


def _trace_both(sim: Simulator, seed: int, elements=None, path_ids=None):
    cfg = sim.cfg
    draws = simulator.path_draws(fold_in(rng.prng_key(seed), 0)[None], cfg,
                                 "cpu", path_ids)
    args = (draws, sim.materials, sim.position, sim.angles, sim.scene, sim.spacing,
            sim.starting_material, cfg)
    kw = {"culled_tris": sim.culled_tris, "intersect_tile_r": sim.intersect_tile_r}
    got = simulator.trace_paths(*args, elements=elements, **kw)
    want = loop_trace(*args, elements=elements, **kw)
    return got, want


@pytest.mark.parametrize("scene,overrides", [
    ("sphere", {}),
    ("sphere", {"bug_compat_material_transition": False}),
    ("sphere", {"cull_time_window": False}),
    ("liver", {}),
    ("liver", {"bug_compat_material_transition": False, "cull_time_window": False}),
])
def test_trace_paths_on_the_cpu_is_the_loop_it_replaces(request, scene, overrides):
    pack = request.getfixturevalue(scene)
    cfg = dataclasses.replace(small_test_config(transducer_elements=32, samples_per_element=2),
                              **overrides)
    sim = Simulator(pack, cfg, device="cpu", seed=1)
    kernels.reset_launch_counts()
    got, want = _trace_both(sim, 7)
    assert kernels.launch_counts()["bounce"] == 0
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        assert torch.equal(got[key], want[key]), key
    assert int(got["valid"].sum()) > cfg.transducer_elements * cfg.samples_per_element
    if scene == "liver":  # the vascular state machine ran
        assert (got["media_id"] != sim.starting_material).any()


def test_trace_paths_on_a_sharded_subset_is_the_loop_it_replaces(sphere):
    """``elements=``: the second quarter of the elements, their global path
    ids keying the draws, each path's local RF column."""
    cfg = small_test_config(transducer_elements=32, samples_per_element=2)
    sim = Simulator(sphere, cfg, device="cpu", seed=1)
    positions, directions = element_layout(sim.position, sim.angles, cfg)
    mine = slice(8, 16)
    s = cfg.samples_per_element
    path_ids = torch.arange(8 * s, 16 * s)
    local = torch.arange(8, dtype=torch.int32).repeat_interleave(s)
    got, want = _trace_both(sim, 3, (positions[mine], directions[mine], local), path_ids)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert got["valid"].shape == (cfg.max_depth, 8 * s)


def test_the_wrapper_on_cpu_tensors_is_bounce_plain(sphere):
    """``Bounces`` bounce by bounce against ``rays_plain`` and
    ``bounce_plain`` called by hand: the queries, the segments and the final
    state equal; nothing launches or counts."""
    cfg = small_test_config(transducer_elements=16, samples_per_element=2)
    sim = Simulator(sphere, cfg, device="cpu", seed=1, use_culled_intersect=False)
    n = cfg.transducer_elements * cfg.samples_per_element
    draws = sim.draws(5)
    positions, directions = element_layout(sim.position, sim.angles, cfg)
    kernels.reset_launch_counts()
    bounces = bounce.Bounces(positions, directions, cfg.samples_per_element, draws, sim.materials,
                             sim.scene, sim.spacing, sim.starting_material, cfg)
    state = {"src": positions.repeat_interleave(2, dim=0),
             "direction": directions.repeat_interleave(2, dim=0),
             "media_id": torch.full((n,), sim.starting_material, dtype=torch.int32),
             "media_outside_id": torch.full((n,), -1, dtype=torch.int32),
             "intensity": torch.full((n,), cfg.initial_intensity / 2, dtype=torch.float32),
             "distance_mm": torch.zeros(n), "alive": torch.ones(n, dtype=torch.bool)}
    thick = physics.take_rows(sim.materials, sim.scene["mesh_mat_inside"])[:, physics.THICKNESS]
    record = []
    for d in range(cfg.max_depth):
        query = bounce.rays_plain(state, sim.materials, sim.spacing, cfg)
        origin, seg_vec = bounces.query
        assert torch.equal(origin, query["origin"]) and torch.equal(seg_vec, query["seg_vec"])
        hits = intersect_closest_cuda(origin, seg_vec, sim.scene["tri_soa"],
                                                sim.scene["tri_mesh_id"])
        bounces.step(hits)
        segment, state = bounce.bounce_plain(hits, {k: v[d] for k, v in draws.items()}, state,
                                             query, sim.materials, thick, sim.scene, sim.spacing,
                                             cfg)
        record.append({**segment, "rays": torch.cat([origin, seg_vec], dim=1).T})
    got = bounces.segments()
    for key in bounce.SEGMENT_FIELDS:
        assert torch.equal(got[key], torch.stack([s[key] for s in record])), key
    final = bounces.final_state()
    assert tuple(final) == bounce.STATE_FIELDS
    for key in bounce.STATE_FIELDS:
        assert torch.equal(final[key], state[key]), key
    assert kernels.launch_counts()["bounce"] == 0
    with pytest.raises(ValueError):
        bounces.step(hits)  # all bounces have run


@pytest.mark.parametrize("through", ["materials", "pose"])
def test_a_gradient_through_the_trace_is_the_loops(sphere, through):
    """Each launch's backward (the hand-derived adjoint, recomputed from the
    row the launch started from) against autograd through the loop it
    replaces: the gradient of a weighted sum of every traced segment field
    and the rays into the table, or into the probe's pose (the elements'
    positions and directions), equal to the loop's but for the order the
    launches' partial sums add in."""
    cfg = small_test_config(transducer_elements=16, samples_per_element=2)
    sim = Simulator(sphere, cfg, device="cpu", seed=1)
    draws = sim.draws(4)
    gen = torch.Generator().manual_seed(2)
    weights = None
    grads = []
    for trace in (simulator.trace_paths, loop_trace):
        materials = sim.materials.clone().requires_grad_(through == "materials")
        pose = [p.clone().requires_grad_(through == "pose") for p in (sim.position, sim.angles)]
        segments = trace(draws, materials, *pose, sim.scene, sim.spacing, sim.starting_material,
                         cfg, culled_tris=sim.culled_tris, intersect_tile_r=sim.intersect_tile_r)
        fields = (*simulator.TRACED_FIELDS, "rays")
        if weights is None:
            weights = {k: torch.randn(segments[k].shape, generator=gen) for k in fields}
            assert all(segments[k].requires_grad for k in fields if k != "initial")
        loss = sum((segments[k] * weights[k]).sum() for k in fields)
        grads.append(torch.autograd.grad(loss, [materials] if through == "materials" else pose))
    for got, want in zip(*grads):
        assert bool(want.abs().max() > 0) and bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))


def test_a_fit_through_the_trace_keeps_its_gradient(sphere):
    """A table that requires grad: the segments reach it through the
    launches' backward, finite and not all zero."""
    cfg = small_test_config(transducer_elements=16, samples_per_element=2)
    sim = Simulator(sphere, cfg, device="cpu", seed=1)
    materials = sim.materials.clone().requires_grad_(True)
    draws = sim.draws(2)
    segments = simulator.trace_paths(draws, materials, sim.position, sim.angles, sim.scene,
                                     sim.spacing, sim.starting_material, cfg, **sim.trace_kw)
    (segments["reflected"].sum() + segments["attenuation"].sum()).backward()
    assert materials.grad is not None and bool(materials.grad.abs().sum() > 0)
    assert torch.isfinite(materials.grad).all()


@pytest.mark.parametrize("kernel,launched", [
    ("bounce", ("bounce_physics_kernel<true>", "bounce_physics_kernel<false>")),
    ("bounce_bwd", ("bounce_physics_bwd_kernel<true>", "bounce_physics_bwd_kernel<false>",
                    "bounce_physics_bwd_sum_kernel"))])
def test_bounce_is_a_counted_kernel_with_an_event_name(kernel, launched):
    """``launch_counts`` names the forward ``bounce`` and the backward
    ``bounce_bwd``; each one's event name is in every kernel its C entry
    launches (``csrc/bounce.cu``) and in no other source, in no other
    kernel's event name and in none of the kernels the other launches, and
    holds none of the benchmark's frozen event names or a stage mark's."""
    from benchmark.harness.roofline import EVENT_NAMES as FROZEN

    kernels.reset_launch_counts()
    kernels.add_launch_counts({kernel: 11}, 3)
    assert kernels.launch_counts()[kernel] == 33
    kernels.reset_launch_counts()
    assert kernels.launch_counts()[kernel] == 0
    event = EVENT_NAMES[kernel]
    source = (CSRC / "bounce.cu").read_text()
    launches = re.findall(r"(\w+(?:<\w+>)?)<<<", source)
    assert set(launches) >= set(launched)
    assert all(event in name for name in launched)
    assert not [name for name in launches if name not in launched and event in name]
    assert not [p.name for p in CSRC.glob("*.cu*") if p.name != "bounce.cu"
                and event in p.read_text()]
    assert not [v for k, v in EVENT_NAMES.items() if k != kernel and (event in v or v in event)]
    assert not [v for v in FROZEN.values() if v in event]
    assert not [s for s in profiling.STAGES if event in f"mcray_mark_{s}"]


def test_the_backward_adds_without_atomics():
    """The table's gradient is summed in a fixed order (per block, then
    the blocks in order): ``csrc/bounce.cu`` calls no atomic operation
    (its comments aside)."""
    code = [line.split("//")[0] for line in (CSRC / "bounce.cu").read_text().splitlines()]
    assert not [line for line in code if "atomic" in line]


def test_the_backward_refuses_a_spacing_gradient(sphere):
    """A gradient of ``spacing`` through the trace raises: the launches'
    backward computes none (and never falls back to the plain rerun)."""
    cfg = small_test_config(transducer_elements=16, samples_per_element=2)
    sim = Simulator(sphere, cfg, device="cpu", seed=1)
    spacing = sim.spacing.clone().requires_grad_(True)
    segments = simulator.trace_paths(sim.draws(2), sim.materials, sim.position, sim.angles,
                                     sim.scene, spacing, sim.starting_material, cfg, **sim.trace_kw)
    with pytest.raises(ValueError, match="spacing"):
        segments["reflected"].sum().backward()


@pytest.mark.parametrize("struct,block", [("McrayBounceArgs", "_Args"),
                                          ("McrayBounceBwdArgs", "_BwdArgs")])
def test_the_argument_block_mirrors_the_c_struct(struct, block):
    """``_Args`` lists ``McrayBounceArgs``' fields in its order and types,
    and ``_BwdArgs`` the backward's ``McrayBounceBwdArgs``' (the forward's
    block, then its own), so the launch reads what the wrapper wrote."""
    body = re.search(rf"struct {struct} \{{(.*?)\n\}};", (CSRC / "bounce.cu").read_text(),
                     re.S).group(1)
    c_fields = []
    for line in body.splitlines():
        code = line.split("//")[0].strip()
        if code:
            c_type, name = code.rstrip(";").rsplit(" ", 1)
            c_fields.append((name.lstrip("*"), "P" if "*" in code else c_type))
    kinds = {"int": bounce.I, "float": bounce.F, "P": bounce.P, "McrayBounceArgs": bounce._Args}
    py_fields = [(name.rstrip("_"), kind) for name, kind in getattr(bounce, block)._fields_]
    assert [(name, kinds[c_type]) for name, c_type in c_fields] == py_fields


def hazard_bounces(cull: bool, n_group: int = 64):
    """Made-up bounces whose lanes sit on each hazard of the adjoint, the
    card test's set-up widened: paths from a medium of impedance 3 into one
    of 1.5 at 40-85 degrees (total internal reflection), along a boundary
    between equal impedances with the normal held to the surface's
    (``refr_sq`` exactly 0, nothing reflected), near-normal into a vessel
    (the vascular transition), and random paths on random normals with
    random power-cosine draws; every 7th path misses, the roulette takes
    both branches, paths die below eps and, with ``cull``, leave the time
    window. Returns the config, the ``Bounces`` (CPU, the record filled
    by the plain version), its inputs and each bounce's hits."""
    cfg = small_test_config(cull_time_window=cull)
    n, d = 4 * n_group, cfg.max_depth
    gen = torch.Generator().manual_seed(3)
    materials = torch.tensor([[3.0, 0.5, 0.1, 1.0, 0.2, 0.5, 1e6, 0.01],
                              [1.5, 0.7, 0.2, 1.0, 0.3, 0.7, 3.0, 0.02],
                              [3.0, 0.6, 0.2, 1.0, 0.3, 0.5, 1e6, 0.0],
                              [1.2, 0.2, 0.1, 1.0, 0.3, 2.0, 10.0, 0.01]])
    scene = {"mesh_mat_inside": torch.tensor([1, 2, 3], dtype=torch.int32),
             "mesh_mat_outside": torch.tensor([0, 0, 0], dtype=torch.int32),
             "mesh_is_vascular": torch.tensor([False, False, True])}
    spacing = torch.tensor([1.0, 1.2, 0.9])
    k = torch.arange(n_group, dtype=torch.float32)
    tir = torch.deg2rad(40.0 + 45.0 * k / (n_group - 1))
    near = torch.deg2rad(10.0 * k / (n_group - 1))
    rand = torch.randn(n_group, 3, generator=gen)
    directions = torch.cat([torch.stack([torch.sin(tir), torch.zeros_like(k), -torch.cos(tir)], 1),
                            torch.tensor([[1.0, 0.0, 0.0]]).expand(n_group, 3),
                            torch.stack([torch.sin(near), torch.zeros_like(k), -torch.cos(near)], 1),
                            rand / rand.norm(dim=1, keepdim=True)])
    positions = torch.rand(n, 3, generator=gen)
    draws_ = {name: torch.rand(d, n, generator=gen) for name in bounce.FIELDS}
    draws_["q_normal"] = torch.randn(d, n, generator=gen)
    draws_["angle_u"][:, :3 * n_group] = 1.0
    normal = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3).clone()
    normal[3 * n_group:] = torch.nn.functional.normalize(torch.randn(n_group, 3, generator=gen))
    mesh = torch.arange(4).repeat_interleave(n_group).clamp(max=2).int()
    mesh[3 * n_group:] = torch.randint(0, 3, (n_group,), generator=gen).int()
    hits = []
    for _ in range(d):
        hit = torch.ones(n, dtype=torch.bool)
        hit[::7] = False
        hits.append({"hit": hit, "point": torch.rand(n, 3, generator=gen) * 4.0 - 2.0,
                     "normal": normal, "mesh_id": mesh})
    b = bounce.Bounces(positions, directions, 1, draws_, materials, scene, spacing, 0, cfg)
    for h in hits:
        b.step(h)
    return cfg, b, (positions, directions, materials, spacing), hits


def traced_bounces(sphere):
    """A sphere frame's bounces on the CPU (32 elements, 2 paths each) with
    its own closest hits, as ``hazard_bounces`` returns them."""
    cfg = small_test_config(transducer_elements=32, samples_per_element=2)
    sim = Simulator(sphere, cfg, device="cpu", seed=1)
    positions, directions = element_layout(sim.position, sim.angles, cfg)
    closest_hit = simulator.closest_hit_fn(sim.scene, **sim.trace_kw)
    b = bounce.Bounces(positions, directions, 2, sim.draws(5), sim.materials, sim.scene,
                       sim.spacing, sim.starting_material, cfg)
    hits = []
    for _ in range(cfg.max_depth):
        hits.append(closest_hit(*b.query))
        b.step(hits[-1])
    return cfg, b, (positions, directions, sim.materials, sim.spacing), hits


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| (0 where both are 0)."""
    want = torch.zeros_like(got) if want is None else want
    scale = float(want.norm())
    err = float((got - want).norm())
    return err / scale if scale else err


@pytest.mark.parametrize("case", ["hazards, cull", "hazards, no cull", "sphere"])
def test_the_adjoint_is_autograd_over_the_plain_rerun_launch_by_launch(sphere, case):
    """Each launch's hand-derived adjoint (``start_adjoint_plain`` for row
    0, ``bounce_adjoint_plain`` for each bounce: the backward on the CPU and
    the backward kernel's plain twin) against autograd over the plain
    version rerun on the launch's inputs (``rerun_grads``,
    ``rerun_bounce_grads``), with random
    gradients on every output: every input's gradient (row 0's positions,
    directions and table; each bounce's row fields, the hits' point and
    normal, the table) within 1e-5 relative L2. The made-up lanes reach
    every hazard of the derivation in some launch: total internal
    reflection, ``refr_sq`` exactly 0, dead paths and misses, both roulette
    branches, intensities cut at eps, a vascular transition and, with the
    cull on, paths that leave the time window."""
    with torch.no_grad():
        if case == "sphere":
            cfg, b, inputs, hits = traced_bounces(sphere)
        else:
            cfg, b, inputs, hits = hazard_bounces(cull=case == "hazards, cull")
    record, n = b.record, inputs[0].shape[0] * b.record.local_samples
    gen = torch.Generator().manual_seed(11)

    def rand(*shape):
        return torch.randn(*shape, generator=gen)

    row_shapes = {"from": (n, 3), "direction": (n, 3), "initial": (n,), "distance": (n,),
                  "attenuation": (n,), "to": (n, 3), "query": (2, n, 3)}
    grads = {k: rand(*s) for k, s in row_shapes.items()}
    grads["initial"] = grads["distance"] = None  # row 0's are not differentiable
    got = record.start_backward(inputs, grads, want_pose=True, want_table=True)
    want = rerun_grads(rerun_start(record), inputs, (True, True, True, False),
                              [grads[k] for k in bounce.GRADED_ROW])
    for name, w in zip(("positions", "directions", "materials"), want):
        assert rel_l2(got[name], w) <= 1e-5, ("start", name, rel_l2(got[name], w))

    seen = dict.fromkeys(("tir", "refr_sq 0", "dead", "miss", "reflect", "refract",
                          "reflection cut", "refraction cut", "vascular", "culled"), 0)
    names = (*bounce.GRADED_ROW[:-1], "point", "normal", "materials")
    for d, h in enumerate(hits):
        row = record.row(d)
        nxt = {k: rand(*s) for k, s in row_shapes.items()}
        if d == 3:
            nxt["query"] = None  # a gradient that does not arrive
        g = {"to": rand(n, 3), "reflected": None if d == 5 else rand(n), "next": nxt}
        got = record.bounce_backward(d, row, h, inputs[2], inputs[3], g, set(names))
        want = rerun_bounce_grads(record, d, row, h, inputs[2], inputs[3], g,
                                         [True] * 10 + [False])
        for name in names:
            err = rel_l2(got[name], want[name])
            assert torch.isfinite(got[name]).all() and err <= 1e-5, (d, name, err)

        draws = {k: v[d] for k, v in record.draws.items()}
        state = bounce.state_of(row)
        p = bounce.bounce_parts(h, draws, state, bounce.row_as_query(row), inputs[2],
                                bounce.thickness_by_mesh(inputs[2], record.scene), record.scene,
                                inputs[3], cfg, parts=True)
        hb, hit, eps = p["hb"], p["hit"], cfg.intensity_epsilon
        seen["tir"] += int((hit & hb["tir"]).sum())
        seen["refr_sq 0"] += int((hit & ~hb["tir"] & ~hb["refracts"]).sum())
        seen["dead"] += int((~state["alive"]).sum())
        seen["miss"] += int((state["alive"] & ~h["hit"]).sum())
        seen["reflect"] += int((hit & hb["chose_reflection"]).sum())
        seen["refract"] += int((hit & ~hb["chose_reflection"]).sum())
        seen["reflection cut"] += int((hit & ~(hb["i_refl"] > eps)).sum())
        seen["refraction cut"] += int((hit & ~(hb["i_refr"] > eps)).sum())
        seen["vascular"] += int((hit & record.scene["mesh_is_vascular"][
            h["mesh_id"].long().clamp(min=0)]).sum())
        seen["culled"] += int((hit & (hb["new_intensity"] > eps) & ~p["next"]["alive"]).sum())
    if case == "sphere":
        assert seen["reflect"] and seen["refract"] and seen["dead"] and seen["miss"], seen
    else:
        assert all(v > 0 for k, v in seen.items() if k != "culled"), seen
        assert (seen["culled"] > 0) == (case == "hazards, cull"), seen
