"""The CUDA kernels against their plain versions, on an NVIDIA GPU.

These tests need the card and the CUDA toolkit (the kernels are built with
nvcc at first use); without a GPU they skip. They import no JAX, so they
also run where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerances are those of chip_smoke.py: the closest hits (K1 also at edge
shapes of rays and triangles, and the
cluster kernels K5 listed, K6 culled, K7 staged, K10 grouped) bitwise in t and winning
index (FMA contraction is off in the kernels, and plain PyTorch on CUDA
rounds every op), the march at rtol 1e-4 / atol 1e-5 in each of its four
texture modes and bitwise in every bitsum field mode (Box–Muller: 1e-4 /
1e-5 with gate flips counted), the postproc at 1e-5 / 1e-6 (bitwise on
images of 993 to 2,000 rows), the modes run in plain torch on the card at
1e-4 / 1e-5 against the CPU, and the scan conversion bitwise against its
plain versions (1e-6 / 1e-6 through the frame's autograd Function); the march backward (K8) per SoA field within 1e-4 of the field's
largest plain entry, the scan-conversion backward (K9) bitwise against its
CSR lists summed in order on the host and at 1e-5 / 1e-6 against the
scatter-add plain version, and a whole fit step's loss and material
gradient against the CPU plain path. K10 is held per ray (t and slot
bitwise) against ``grouped_winners_plain``. K11 (the BVH traversal) is held
bitwise to its plain version (t, winner, node and test counts of the 4-wide
walk) and to the binary walk and K1 (t, winner) at edge shapes, ray counts
that fill no block and 20,480 rays, and its sphere frame to the brute frame; one pose fd step on
the card against the CPU (point losses rtol 1e-4, gradient 1e-3 of its
largest entry, pose 1e-5); ``serve``'s drain waits on the drained frame's
event and nothing else. The frame axis: K3, K4 and K9 over 3 frames that
differ, in one launch each, bitwise the kernel per frame (B = 1: the 2-D
call); a batched frame bitwise ``render_frame``'s; the batched pose fd step
bitwise its per-point loop, and a 2-frame fit step's loss bitwise and its
gradient within 1e-5 of its largest entry against its loop of frames. The parallel layer on a one-rank NCCL group: the
sharded frame's RF bitwise the ``Simulator``'s (the gathered B-mode too, the
halo B-mode at 1e-5 / 1e-6), and a cuda mesh raises where NCCL is missing;
``render``'s ``rf_conv`` is ``rf_raw`` where K3 runs; ``FrameMetrics`` waits
on the card for a CUDA tensor. The measuring layer: ``graph_ms`` and
``busy_view`` of one K4 launch, and the stage table of a small sphere frame.
The chained batch: replayed from a CUDA graph, bitwise its steps run
eagerly and ``render_frames`` of the last step's keys, for two seeds; under
the profiler its replays show every stage mark of every step, the launch
counters count the replays, and the marked graph's B-modes are bitwise the
eager, unmarked steps'.
"""

import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from _torch_port import SPHERE_SCENE, random_segments, random_triangles, to_torch
from mcray_tpu_torch.config import SimConfig, small_test_config
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.models.trainer import PoseFitter
from mcray_tpu_torch.ops import bvh, clusters, geometry, imaging
from mcray_tpu_torch.ops import physics
from mcray_tpu_torch.ops.cuda import (_build, bvh_intersect, intersect, intersect_culled,
                                      intersect_grouped, intersect_listed, intersect_staged, march,
                                      postproc, scanconv)
from mcray_tpu_torch.scene.compile import load_and_compile
from mcray_tpu_torch.utils import rng

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    return torch.device("cuda")


def test_intersect_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    tris, _ = random_triangles(rng, 700)
    o, s = random_segments(rng, 1000)
    rays = to_torch(np.concatenate([o, s], axis=1)).T.contiguous().to(cuda)
    tri_soa = geometry.triangle_soa(to_torch(tris)).to(cuda)
    before = intersect.launches
    t_k, i_k = intersect.intersect_best(rays, tri_soa)
    t_p, i_p = intersect.intersect_best_plain(rays, tri_soa)
    assert intersect.launches == before + 1
    assert bool((t_p < 1.5).any())
    assert torch.equal(t_k, t_p) and torch.equal(i_k, i_p)


def _k1_blocks(n: int, t: int) -> int:
    """K1's grid: 32-ray tiles x slices of at least 256 triangles (at most 8)."""
    return -(-n // 32) * (1 if t <= 256 else min(8, -(-t // 256)))


@pytest.mark.parametrize("n", [1, 33, 1000, 2560])
@pytest.mark.parametrize("t", [1, 255, 257, 2220])
def test_intersect_kernel_at_edge_shapes(cuda, n, t):
    """K1 (its triangles split over up to 8 cluster blocks of 8 warps) at
    ray counts around its 32-ray tile and triangle counts around its
    256-triangle slice: t and index bitwise the plain version's, one launch,
    the grid it reports."""
    from chip_smoke import k1_edge_case  # duplicated triangles, aimed rays, a dead stretch

    rays, tri_soa = k1_edge_case(n, t)
    before = intersect.launches
    t_k, i_k = intersect.intersect_best(rays, tri_soa)
    assert intersect.launches == before + 1
    assert intersect.last_blocks == _k1_blocks(n, t)
    t_p, i_p = intersect.intersect_best_plain(rays, tri_soa)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(i_k, i_p)
    assert int((t_p < 1.5).sum()) >= n // 4
    if t >= 4 and n > 32:  # some winners have a twin at a higher index
        assert bool(((t_p < 1.5) & (i_p < t // 2)).any())


@pytest.mark.parametrize("t", [0, 1, 2220])
def test_intersect_kernel_on_dead_rays_and_no_triangles(cuda, t):
    """600 parked dead rays (every cluster skips its walk), and live rays
    against no triangle: every ray misses, (2.0, 0)."""
    rng = np.random.default_rng(t)
    tris, _ = random_triangles(rng, t)
    tri_soa = geometry.triangle_soa(to_torch(tris).reshape(-1, 3, 3)).to(cuda)
    dead = torch.cat([torch.full((3, 600), 1e9), torch.zeros((3, 600))]).to(cuda)
    o, s = random_segments(rng, 100)
    live = to_torch(np.concatenate([o, s], axis=1)).T.contiguous().to(cuda)
    for rays in (dead, live) if t == 0 else (dead,):
        t_k, i_k = intersect.intersect_best(rays, tri_soa)
        assert intersect.last_blocks == _k1_blocks(rays.shape[1], t)
        assert bool((t_k == 2.0).all()) and not bool(i_k.any())
        t_p, i_p = intersect.intersect_best_plain(rays, tri_soa)
        assert torch.equal(t_k, t_p) and torch.equal(i_k, i_p)


def _cluster_cases(cuda):
    """(name, rays (6, N)) on the card: the sphere's bounce-0 rays (1,024,
    two 512-ray packets), its first 1,000 bounce-1 rays with every 7th
    parked dead (a ragged last packet), and 600 all-dead rays."""
    pack = load_and_compile(SPHERE_SCENE)
    cfg = small_test_config(transducer_elements=256, samples_per_element=4)
    rays = Simulator(pack, cfg, device=cuda, use_culled_intersect=False).render_frame(0)[
        "segments"]["rays"]
    ragged = rays[1][:, :1000].clone()
    ragged[0:3, ::7], ragged[3:6, ::7] = 1e9, 0.0
    dead = torch.cat([torch.full((3, 600), 1e9), torch.zeros((3, 600))]).to(cuda)
    return pack, [("sphere bounce 0", rays[0]), ("ragged", ragged), ("all dead", dead)]


def _listed_start(s):
    """The running best a single pass starts from: inert lanes at t = 0."""
    live = torch.abs(s).sum(dim=1) > 0
    t0 = torch.where(live, geometry.NO_HIT_T, 0.0)
    return t0, torch.zeros_like(t0, dtype=torch.int32)


@pytest.mark.parametrize("mode,tile_r", [("listed", 512), ("listed", 128), ("listed", 100),
                                         ("listed", 2048)]
                         + [(m, r) for m in ("culled", "staged") for r in (100, 128, 512, 2048)])
def test_cluster_kernels_match_plain(cuda, mode, tile_r):
    """Each cluster kernel at packets of ``tile_r`` rays (100 is no multiple
    of 32, 2,048 more rays than a block has threads): t and slot bitwise
    against its plain version at the kernel's group and at the whole packet,
    and the closest hit's hit and t against K1."""
    pack, cases = _cluster_cases(cuda)
    tile_t = 128 if mode == "listed" else 256
    packed = clusters.pack_tris_culled(pack.tris, pack.tri_mesh_id, pack.bvh.tri_order,
                                       sort_origin=pack.transducer_position, tile_t=tile_t,
                                       device=cuda)
    tri_soa = geometry.triangle_soa(to_torch(pack.tris)).to(cuda)
    mod = {"listed": intersect_listed, "culled": intersect_culled, "staged": intersect_staged}[mode]
    closest = getattr(mod, f"intersect_closest_{mode}")
    for name, rays in cases:
        o, s, padded = clusters.pad_rays(rays[0:3].T, rays[3:6].T, tile_r)
        before = mod.launches
        if mode == "listed":
            lists = clusters.packet_cluster_lists(o, s, packed, tile_r)
            start = _listed_start(s)
            t_k, i_k = mod.listed_best(padded, *lists, *start, packed)
            t_p, i_p = mod.listed_best_plain(padded, *lists, *start, packed)
            # the plain version at the kernel's group size gives the same winner
            t_g, i_g = mod.listed_best_plain(padded, *lists, *start, packed, group=mod.GROUP)
            assert torch.equal(t_g, t_p) and torch.equal(i_g, i_p), name
        else:
            best, plain = ((mod.culled_best, mod.culled_best_plain) if mode == "culled"
                           else (mod.staged_best, mod.staged_best_plain))
            t_k, i_k = best(padded, packed, tile_r)
            assert mod.last_blocks == -(-padded.shape[1] // mod.GROUP), name
            t_p, i_p = plain(padded, packed, tile_r)
            t_g, i_g = plain(padded, packed, tile_r, group=mod.GROUP)
            assert torch.equal(t_k, t_g) and torch.equal(i_k, i_g), name
        assert mod.launches == before + 1, name
        assert torch.equal(t_k, t_p) and torch.equal(i_k, i_p), name
        # hit and t equal the brute kernel's
        got = closest(rays[0:3].T.contiguous(), rays[3:6].T.contiguous(), packed, tile_r=tile_r)
        bt, bi = intersect.intersect_best(rays.contiguous(), tri_soa)
        assert torch.equal(got["hit"], bt < 1.5), name
        assert torch.equal(got["t"], bt), name
        if name == "all dead":
            assert not bool(got["hit"].any())
        else:
            assert int(got["hit"].sum()) > 20, name


@pytest.mark.parametrize("mode", ["listed", "culled", "staged"])
def test_cluster_kernels_take_the_widest_tile_that_fits(cuda, mode):
    """The shared-memory check counts the kernel's static shared memory:
    at the widest tile_t whose ring and static bytes fit in 48 KB the kernel
    launches and equals its plain version; 4 triangles wider, the wrapper
    raises ValueError before any launch."""
    mod = {"listed": intersect_listed, "culled": intersect_culled, "staged": intersect_staged}[mode]
    entry = f"mcray_intersect_{mode}"
    static = _build.static_shared(entry)
    assert 0 < static < 4096
    widest = (_build.SHARED_BYTES - static) // 72 // 4 * 4
    pack, cases = _cluster_cases(cuda)
    rays = cases[0][1]
    for tile_t in (widest, widest + 4):
        packed = clusters.pack_tris_culled(pack.tris, pack.tri_mesh_id, pack.bvh.tri_order,
                                           sort_origin=pack.transducer_position, tile_t=tile_t,
                                           device=cuda)
        o, s, padded = clusters.pad_rays(rays[0:3].T, rays[3:6].T, 512)
        args = ((padded, *clusters.packet_cluster_lists(o, s, packed, 512), *_listed_start(s),
                 packed) if mode == "listed" else (padded, packed, 512))
        kernel, plain = getattr(mod, f"{mode}_best"), getattr(mod, f"{mode}_best_plain")
        before = mod.launches
        if tile_t > widest:
            with pytest.raises(ValueError, match="static shared memory"):
                kernel(*args)
            assert mod.launches == before
        else:
            t_k, i_k = kernel(*args)
            t_p, i_p = plain(*args)
            assert mod.launches == before + 1
            assert torch.equal(t_k, t_p) and torch.equal(i_k, i_p)
            assert bool((t_k < 1.5).any())


@pytest.mark.parametrize("tile_r", [512, 128])
def test_listed_kernel_two_passes_match_brute(cuda, tile_r):
    """passes=2 (two launches, the second seeded with the first's running
    best) gives K1's hit and t, and the second launch equals its plain
    version on the seeded start."""
    pack, cases = _cluster_cases(cuda)
    packed = clusters.pack_tris_culled(pack.tris, pack.tri_mesh_id, pack.bvh.tri_order,
                                       sort_origin=pack.transducer_position, tile_t=128,
                                       device=cuda)
    tri_soa = geometry.triangle_soa(to_torch(pack.tris)).to(cuda)
    for name, rays in cases:
        before = intersect_listed.launches
        got = intersect_listed.intersect_closest_listed(
            rays[0:3].T.contiguous(), rays[3:6].T.contiguous(), packed, tile_r=tile_r, passes=2,
            front_k=2)
        assert intersect_listed.launches == before + 2, name
        bt, _ = intersect.intersect_best(rays.contiguous(), tri_soa)
        assert torch.equal(got["hit"], bt < 1.5) and torch.equal(got["t"], bt), name
        # a seeded launch: the first two list slots, then the whole list from there
        o, s, padded = clusters.pad_rays(rays[0:3].T, rays[3:6].T, tile_r)
        counts, ids, keys = clusters.packet_cluster_lists(o, s, packed, tile_r)
        first = intersect_listed.listed_best(padded, torch.clamp(counts, max=2), ids, keys,
                                             *_listed_start(s), packed)
        t_k, i_k = intersect_listed.listed_best(padded, counts, ids, keys, *first, packed)
        t_p, i_p = intersect_listed.listed_best_plain(padded, counts, ids, keys, *first, packed)
        assert torch.equal(t_k, t_p) and torch.equal(i_k, i_p), name


@pytest.mark.parametrize("budget", [(32, 4), (8, 1), (16, 2)])
def test_grouped_kernel_matches_plain(cuda, budget):
    """K10 per ray (t and slot, bitwise) against ``grouped_winners_plain``:
    the sphere's coherent bounce-0 fan (full clusters), its ragged bounce-1
    rays, one ray in 97 (clusters of one ray) and no live ray; and the whole
    grouped closest hit (prepass, K10, residual K5) against K1. Each case
    with live rays must do real work: more than 20 hits and 50 table slots
    (the sparse case, 11 live rays, more than 5 of each)."""
    pack, cases = _cluster_cases(cuda)
    packed = clusters.pack_tris_culled(pack.tris, pack.tri_mesh_id, pack.bvh.tri_order,
                                       sort_origin=pack.transducer_position, tile_t=128,
                                       device=cuda)
    tri_soa = geometry.triangle_soa(to_torch(pack.tris)).to(cuda)
    sparse = cases[0][1].clone()
    keep = torch.arange(sparse.shape[1], device=cuda) % 97 == 0
    sparse[0:3, ~keep], sparse[3:6, ~keep] = 1e9, 0.0
    g = budget[0]
    shapes = {}
    for name, rays in cases + [("one ray in 97", sparse)]:
        o, s, padded = clusters.pad_rays(rays[0:3].T, rays[3:6].T, 512, 1e9)
        hit, _ = clusters.ray_cluster_hits(o, s, packed)
        ray_ids, counts, _ = clusters.cluster_ray_tables(hit, *budget)
        shapes[name] = (int((counts == 1).sum()), int((counts == ray_ids.shape[1]).sum()))
        want = intersect_grouped.grouped_winners_plain(padded, ray_ids, counts, packed)
        before = (intersect_grouped.launches, intersect_listed.launches)
        t_k, i_k = intersect_grouped.grouped_winners(padded, ray_ids, counts, packed)
        assert intersect_grouped.launches == before[0] + 1, name
        assert intersect_grouped.last_blocks >= 1
        assert torch.equal(t_k.view(torch.int32), want[0].view(torch.int32)), name
        assert torch.equal(i_k, want[1]), name
        got = intersect_grouped.intersect_closest_grouped(
            rays[0:3].T.contiguous(), rays[3:6].T.contiguous(), packed, group_g=g,
            chunk_g=budget[1], residual_tile_r=512)
        assert (intersect_grouped.launches, intersect_listed.launches) == (
            before[0] + 2, before[1] + 1), name
        bt, _ = intersect.intersect_best(rays.contiguous(), tri_soa)
        assert torch.equal(got["hit"], bt < 1.5) and torch.equal(got["t"], bt), name
        if name == "all dead":
            assert not bool(got["hit"].any()) and int(counts.sum()) == 0
            assert bool((want[0] == geometry.NO_HIT_T).all()) and not bool(want[1].any())
        else:
            hits, slots = (5, 5) if name == "one ray in 97" else (20, 50)
            assert int(got["hit"].sum()) > hits and int(counts.sum()) > slots, name
    assert shapes["one ray in 97"][0] > 0 and shapes["sphere bounce 0"][1] > 0, shapes


def test_keyed_draws_on_the_card_match_the_cpu(cuda):
    """Keys, bits and uniforms are integer work: equal bitwise on the card
    and the CPU. The normal goes through each device's ``erfinv``."""
    key = rng.prng_key(12)
    ids = torch.arange(3000)
    on = {dev: rng.fold_in(rng.fold_in(key.to(dev), 0), ids.to(dev)) for dev in ("cpu", cuda)}
    assert torch.equal(on[cuda].cpu(), on["cpu"])
    for fn in (lambda k: rng.split(k, 3), lambda k: rng.random_bits(k, (4,)), rng.uniform,
               lambda k: rng.randint(k, (2,), 0, 2**31 - 1)):
        assert torch.equal(fn(on[cuda]).cpu(), fn(on["cpu"]))
    draws = {dev: physics.draw_bounce_randoms(keys, 10) for dev, keys in on.items()}
    for name in ("angle_u", "axis_u", "radius_u", "roulette_u"):
        assert torch.equal(draws[cuda][name].cpu(), draws["cpu"][name]), name
    np.testing.assert_allclose(draws[cuda]["q_normal"].cpu(), draws["cpu"]["q_normal"],
                               rtol=1e-5, atol=1e-6)
    sim = Simulator(load_and_compile(SPHERE_SCENE), small_test_config(), device=cuda, seed=3)
    a, b = sim.render_frame(8)["bmode"], sim.render_frame(8)["bmode"]
    assert torch.equal(a, b) and float(a.std()) > 0  # one seed, one frame


def test_frame_kernels_match_plain(cuda):
    cfg = small_test_config()
    sim = Simulator(load_and_compile(SPHERE_SCENE), cfg, device=cuda)
    out = sim.render_frame(1)
    soa, seeds = out["soa"], sim.seeds
    np.testing.assert_allclose(
        march.march_cuda(soa, seeds, cfg, cfg.rf_cols).cpu(),
        march.march_plain(soa, seeds, cfg, cfg.rf_cols).cpu(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        postproc.postproc_cuda(out["rf_raw"], cfg).cpu(),
        postproc.postproc_plain(out["rf_raw"], cfg).cpu(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        scanconv.scan_convert_cuda(out["rf_env"], sim.scan_maps).cpu(),
        scanconv.scan_convert_plain(out["rf_env"], sim.scan_maps.table, cfg.bmode_cols).cpu(),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["sphere frame", "full size", "linear", "phased", "ragged"])
def test_scan_convert_kernel_matches_plain_bitwise(cuda, case):
    """K4 (weights computed from the two coordinate maps, a thread per
    pixel) bitwise against its map-driven plain version and the table-driven
    one: the sphere frame's enveloped RF, a full-size image, the linear and
    phased maps, and 101 x 123 pixels (a ragged last block)."""
    overrides = {"linear": {"probe_type": "linear"}, "phased": {"probe_type": "phased"},
                 "ragged": {"bmode_rows": 101, "bmode_cols": 123}}.get(case, {})
    cfg = SimConfig() if case == "full size" else small_test_config(**overrides)
    if case == "sphere frame":
        sim = Simulator(load_and_compile(SPHERE_SCENE), cfg, device=cuda)
        rf, maps = sim.render_frame(1)["rf_env"], sim.scan_maps
    else:
        gen = torch.Generator(device=cuda).manual_seed(8)
        rf = torch.randn((cfg.rf_rows, cfg.rf_cols), device=cuda, generator=gen)
        maps = scanconv.scan_maps(*imaging.scan_conversion_maps(cfg), cfg.rf_rows, cfg.rf_cols,
                                  device=cuda)
    before = scanconv.launches
    got = scanconv.scan_convert_forward(rf, maps)
    assert scanconv.launches == before + 1
    assert scanconv.last_blocks == -(-cfg.bmode_rows * cfg.bmode_cols // 128)
    assert torch.equal(got, scanconv.scan_convert_coords_plain(rf, maps.coords))
    assert torch.equal(got, scanconv.scan_convert_plain(rf, maps.table, cfg.bmode_cols))
    assert float(got.abs().max()) > 0


def _made_up_images():
    """(name, image) for K3: all zeros; columns with plateaus and a column
    without a peak among noise; an image narrower than the lateral window
    (no convolution); a short one (fewer than 3 rows: no envelope)."""
    g = torch.Generator().manual_seed(9)
    shaped = torch.randn((465, 64), generator=g)
    shaped[:, 3] = torch.linspace(1.0, -1.0, 465)              # falling: no peak
    shaped[:, 4] = torch.arange(465).div(5, rounding_mode="floor") % 3   # plateaus of 5 rows
    shaped[:, 5] = 0.25                                         # flat
    shaped[100:140, :] = shaped[100:101, :]                     # a plateau across every column
    return [("zeros", torch.zeros((465, 512))), ("plateaus and no peak", shaped),
            ("narrower than the lateral window", torch.randn((465, 16), generator=g)),
            ("two rows", torch.randn((2, 40), generator=g)),
            ("ragged strip", torch.randn((61, 37), generator=g))]


def test_postproc_kernel_matches_plain_on_made_up_images(cuda):
    cfg = SimConfig()
    for name, image in _made_up_images():
        rf = image.to(cuda)
        before = postproc.launches
        got = postproc.postproc_forward(rf, cfg)
        assert postproc.launches == before + 1, name
        assert postproc.last_blocks == -(-rf.shape[1] // 4), name
        np.testing.assert_allclose(got.cpu(), postproc.postproc_plain(rf, cfg).cpu(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("rows", [993, 1200, 2000])
def test_postproc_kernel_takes_tall_images(cuda, rows):
    """K3 past 992 rows (its taller-run instance) and, at 2,000 rows, past a block's
    shared memory (its buffers in device memory): bitwise the plain version,
    on noise with plateaus and a long stretch without a peak."""
    cfg = SimConfig()
    g = torch.Generator().manual_seed(rows)
    rf = torch.randn((rows, 96), generator=g)
    rf[:, 7] = torch.linspace(1.0, -1.0, rows)
    rf[900:1100, 9] = 0.5
    rf = rf.to(cuda)
    before = postproc.launches
    got = postproc.postproc_forward(rf, cfg)
    assert postproc.launches == before + 1
    assert torch.equal(got, postproc.postproc_plain(rf, cfg))


MODES = {
    "hard_nearest": {},
    "soft_nearest": {"soft_scattering": True},
    "hard_trilinear": {"trilinear_texture": True},
    "soft_trilinear": {"soft_scattering": True, "trilinear_texture": True},
}


@pytest.mark.parametrize("mode", MODES)
def test_march_kernels_match_plain_in_every_mode(cuda, mode):
    """K2 and K8 against their plain versions, and the ``Function`` routes
    its forward and backward through them (one launch each)."""
    cfg = small_test_config(**MODES[mode])
    sim = Simulator(load_and_compile(SPHERE_SCENE), cfg, device=cuda)
    soa, seeds = sim.render_frame(1)["soa"], sim.seeds
    g = torch.randn((cfg.rf_rows, cfg.rf_cols), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(2))
    before = (march.launches, march.launches_bwd)
    x = soa.clone().requires_grad_(True)
    rf = march.march_cuda(x, seeds, cfg, cfg.rf_cols)
    (got,) = torch.autograd.grad(rf, x, g)
    assert (march.launches, march.launches_bwd) == (before[0] + 1, before[1] + 1)
    np.testing.assert_allclose(rf.detach().cpu(),
                               march.march_plain(soa, seeds, cfg, cfg.rf_cols).cpu(),
                               rtol=1e-4, atol=1e-5)
    want = march.march_bwd_plain(soa, seeds, g, cfg)
    assert float(want.abs().max()) > 0
    for f in range(march.N_FIELDS):
        err = float((got[:, f] - want[:, f]).abs().max())
        assert err <= 1e-4 * float(want[:, f].abs().max()), (f, err)


FIELD_MODES = [dict(scatter_rng=rng_mode, trilinear_texture=tri, soft_scattering=soft,
                    volume_size=size)
               for rng_mode in ("bitsum", "boxmuller") for tri in (False, True)
               for soft in (False, True) for size in (256, 48)] + [dict(texture_mode="table")]


@pytest.mark.parametrize("overrides", FIELD_MODES, ids=lambda o: "-".join(map(str, o.values())))
def test_march_kernels_in_every_field_mode(cuda, overrides):
    """K2 and K8 against their plain versions on the card in every mode of
    the scatterer field: K2 bitwise with bitsum normals; with Box–Muller
    (the card's logf/cosf/sinf on both sides) rtol 1e-4 / atol 1e-5, cells
    outside it counted as gate flips, at most 0.1% of the image; K8 per
    field within 1e-4 of the field's largest plain entry, outside the
    columns of a flipped cell."""
    cfg = small_test_config(**overrides)
    sim = Simulator(load_and_compile(SPHERE_SCENE), cfg, device=cuda)
    soa, seeds = sim.render_frame(1)["soa"], sim.seeds
    g = torch.randn((cfg.rf_rows, cfg.rf_cols), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(6))
    got = march.march_forward(soa, seeds, cfg, cfg.rf_cols)
    want = march.march_plain(soa, seeds, cfg, cfg.rf_cols)
    keep = torch.ones(cfg.rf_cols, dtype=torch.bool, device=cuda)
    if cfg.scatter_rng == "bitsum":
        assert torch.equal(got, want)
    else:
        off = ~torch.isclose(got, want, rtol=1e-4, atol=1e-5)
        assert int(off.sum()) <= 1e-3 * off.numel()
        keep = ~off.any(dim=0)
    got_g = march.march_backward(soa, seeds, g, cfg)[:, :, : cfg.rf_cols]
    want_g = march.march_bwd_plain(soa, seeds, g, cfg)[:, :, : cfg.rf_cols]
    assert float(want_g.abs().max()) > 0
    for f in range(march.N_FIELDS):
        err = float((got_g[:, f] - want_g[:, f])[:, keep].abs().max())
        assert err <= 1e-4 * float(want_g[:, f].abs().max()), (f, err)


@pytest.mark.parametrize("overrides", [
    {"centered_psf": True}, {"envelope_mode": "hilbert"}, {"soft_row_binning": True},
    {"texture_mode": "table"}, {"texture_mode": "table", "soft_row_binning": True},
    {"scatter_rng": "boxmuller"}, {"volume_size": 48},
], ids=["centered-psf", "hilbert", "soft-row-binning", "table", "table-soft-row-binning",
        "boxmuller", "volume-48"])
def test_modes_on_the_card_match_the_cpu(cuda, overrides):
    """The modes the reference runs outside its kernels render on the card
    (plain torch there, on the CUDA tensors) as on the CPU, same draws, and
    so do K2's field modes; the march kernel is skipped under soft row
    binning, K3 under the centered PSF and the Hilbert envelope."""
    cfg = small_test_config(**overrides)
    pack = load_and_compile(SPHERE_SCENE)
    cpu = Simulator(pack, cfg, device="cpu", seed=5)
    gpu = Simulator(pack, cfg, device=cuda, seed=5)
    draws = cpu.draws(5)
    before = (march.launches, postproc.launches)
    on_gpu = gpu.render_frame(draws={k: v.to(cuda) for k, v in draws.items()})
    on_cpu = cpu.render_frame(draws=draws)
    assert march.launches - before[0] == int(not cfg.soft_row_binning)
    assert postproc.launches - before[1] == int(postproc.kernel_modes(cfg))
    # the scatter march sums a pixel's echoes in another order on the card
    # (index_put_ sorts by index there; the same order every run): atol 1e-4
    atol = 1e-4 if cfg.soft_row_binning else 1e-5
    for key in ("rf_raw", "bmode"):
        np.testing.assert_allclose(on_gpu[key].cpu(), on_cpu[key], rtol=1e-4, atol=atol)
    again = gpu.render_frame(draws={k: v.to(cuda) for k, v in draws.items()})
    assert torch.equal(again["rf_raw"], on_gpu["rf_raw"])  # deterministic on the card


@pytest.mark.parametrize("case", ["sphere frame", "full size", "linear", "phased", "ragged",
                                  "fine"])
def test_scan_convert_backward_kernel_matches_plain(cuda, case):
    """K9 (a thread per RF cell over its CSR list) bitwise against the
    lists summed in list order on the host, and at 1e-5 / 1e-6 against the
    scatter-add plain version (another summation order): through the frame's
    autograd Function on the sphere, at full size, on the linear and phased
    maps, on 101 x 123 pixels, and on a 400 x 500 image over 64 RF columns
    (up to 30 taps a cell)."""
    overrides = {"linear": {"probe_type": "linear"}, "phased": {"probe_type": "phased"},
                 "ragged": {"bmode_rows": 101, "bmode_cols": 123},
                 "fine": {"bmode_rows": 400, "bmode_cols": 500}}.get(case, {})
    cfg = SimConfig() if case == "full size" else small_test_config(**overrides)
    gen = torch.Generator(device=cuda).manual_seed(4)
    rf = torch.randn((cfg.rf_rows, cfg.rf_cols), device=cuda, generator=gen).requires_grad_(True)
    g = torch.randn((cfg.bmode_rows, cfg.bmode_cols), device=cuda, generator=gen)
    if case == "sphere frame":
        maps = Simulator(load_and_compile(SPHERE_SCENE), cfg, device=cuda).scan_maps
    else:
        maps = scanconv.scan_maps(*imaging.scan_conversion_maps(cfg), cfg.rf_rows, cfg.rf_cols,
                                  device=cuda)
    before = scanconv.launches_bwd
    out = scanconv.scan_convert_cuda(rf, maps)
    (got,) = torch.autograd.grad(out, rf, g)
    assert scanconv.launches_bwd == before + 1
    assert scanconv.last_blocks_bwd == -(-cfg.rf_rows * cfg.rf_cols // 256)
    row_ptr, pixel, weight = (a.cpu().numpy() for a in (maps.row_ptr, maps.pixel, maps.weight))
    in_order = np.zeros(cfg.rf_rows * cfg.rf_cols, np.float32)
    np.add.at(in_order, np.repeat(np.arange(in_order.size), np.diff(row_ptr)),
              weight * g.cpu().numpy().reshape(-1)[pixel])
    np.testing.assert_array_equal(got.cpu().numpy().reshape(-1), in_order)
    want = scanconv.scan_convert_bwd_plain(g, maps.table, cfg.rf_rows, cfg.rf_cols)
    np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=1e-5, atol=1e-6)
    assert float(got.abs().max()) > 0.5


def test_fit_step_matches_the_cpu_plain_path(cuda):
    """One fit step's loss (rtol 1e-4) and material gradient (5e-3 of its
    largest entry: the trace's backward amplifies the devices' ulp
    differences) on the card against the CPU, same draws."""
    cfg = small_test_config(soft_scattering=True, trilinear_texture=True)
    pack = load_and_compile(SPHERE_SCENE)
    sims = {"cpu": Simulator(pack, cfg, device="cpu", seed=5),
            "cuda": Simulator(pack, cfg, device=cuda, seed=5)}
    draws = sims["cpu"].draws(5)
    start = pack.materials.copy()
    start[3, 1] *= 2.0
    result = {}
    for name, sim in sims.items():
        d = {k: v.to(sim.device) for k, v in draws.items()}
        with torch.no_grad():
            target = sim.render_frame(draws=d)["bmode"]
        mats = torch.tensor(start, device=sim.device, requires_grad=True)
        loss = torch.mean((sim.render_frame(materials=mats, draws=d)["bmode"] - target) ** 2)
        loss.backward()
        result[name] = (float(loss.detach()), mats.grad.cpu().numpy())
    (l_c, g_c), (l_g, g_g) = result["cpu"], result["cuda"]
    np.testing.assert_allclose(l_g, l_c, rtol=1e-4)
    np.testing.assert_allclose(g_g, g_c, rtol=0, atol=5e-3 * np.abs(g_c).max())
    assert np.abs(g_c).max() > 0


def test_wrappers_reject_bad_inputs(cuda):
    cfg = SimConfig()
    rf = torch.zeros((cfg.rf_rows, cfg.rf_cols), device=cuda)
    with pytest.raises(TypeError):
        postproc.postproc_cuda(rf.double(), cfg)
    with pytest.raises(ValueError):
        postproc.postproc_cuda(rf.T, cfg)  # not contiguous
    on_cpu = scanconv.scan_maps(*imaging.scan_conversion_maps(cfg), cfg.rf_rows, cfg.rf_cols)
    with pytest.raises(ValueError):
        scanconv.scan_convert_cuda(rf, on_cpu)  # maps left on the CPU
    on_card = scanconv.scan_maps(*imaging.scan_conversion_maps(cfg), cfg.rf_rows, cfg.rf_cols,
                                 device=cuda)
    coords = on_card.coords
    before = scanconv.launches
    with pytest.raises(TypeError):
        scanconv.scan_convert_forward(rf, dataclasses.replace(on_card, coords=coords.double()))
    with pytest.raises(ValueError):  # one map only
        scanconv.scan_convert_forward(rf, dataclasses.replace(on_card, coords=coords[:1]))
    with pytest.raises(ValueError):  # not contiguous
        scanconv.scan_convert_forward(
            rf, dataclasses.replace(on_card, coords=coords.transpose(1, 2).contiguous().transpose(1, 2)))
    with pytest.raises(ValueError):
        scanconv.scan_convert_forward(rf, dataclasses.replace(on_card, coords=coords.cpu()))
    assert scanconv.launches == before
    g = torch.zeros((cfg.bmode_rows, cfg.bmode_cols), device=cuda)
    before = scanconv.launches_bwd
    for field, bad in (("row_ptr", on_card.row_ptr.long()), ("row_ptr", on_card.row_ptr[:-1]),
                       ("pixel", on_card.pixel.cpu()), ("weight", on_card.weight[:-1])):
        with pytest.raises((TypeError, ValueError)):
            scanconv.scan_convert_backward(g, dataclasses.replace(on_card, **{field: bad}))
    with pytest.raises(ValueError):  # the cotangent's shape
        scanconv.scan_convert_backward(g[:, :-1], on_card)
    assert scanconv.launches_bwd == before
    pack = load_and_compile(SPHERE_SCENE)
    packed = clusters.pack_tris_culled(pack.tris, pack.tri_mesh_id, pack.bvh.tri_order,
                                       tile_t=128, device=cuda)
    padded = torch.zeros((6, 128), device=cuda)
    counts = torch.zeros(packed.n_clusters, dtype=torch.int32, device=cuda)
    before = intersect_grouped.launches
    for width in (4, 12, 264):  # slots per cluster: multiples of 8 in [8, 256]
        ids = torch.zeros((packed.n_clusters, width), dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError):
            intersect_grouped.grouped_winners(padded, ids, counts, packed)
    ids = torch.zeros((packed.n_clusters, 8), dtype=torch.int32, device=cuda)
    # tile_t no multiple of 4; ranges of 804 triangles, whose rings pass 226 KB
    for tile_t in (126, 3204):
        tiles = torch.zeros((packed.n_clusters, clusters.SOA_ROWS, tile_t), device=cuda)
        with pytest.raises(ValueError):
            intersect_grouped.grouped_winners(
                padded, ids, counts, dataclasses.replace(packed, tile_t=tile_t, hbm_tris=tiles))
    with pytest.raises(TypeError):
        intersect_grouped.grouped_winners(padded, ids.long(), counts, packed)
    with pytest.raises(ValueError):  # the card computes no per-slot table
        intersect_grouped.grouped_best(padded, ids, counts, packed)
    assert intersect_grouped.launches == before
    rays = torch.zeros((6, 8), device=cuda)
    tri_soa = torch.zeros((9, 4), device=cuda)
    with pytest.raises(ValueError):
        intersect.intersect_best(rays[:, :0], tri_soa)  # no ray
    with pytest.raises(ValueError):
        intersect.intersect_best(rays[:5], tri_soa)
    with pytest.raises(TypeError):
        intersect.intersect_best(rays, tri_soa.double())
    soa = torch.zeros((4, march.N_FIELDS, 128), device=cuda)
    with pytest.raises(TypeError):
        march.march_cuda(soa.double(), torch.zeros(2, dtype=torch.int64), cfg, 128)
    with pytest.raises(ValueError):
        march.march_cuda(soa, torch.zeros(2, dtype=torch.int64), cfg, 256)  # wider than the SoA


def _bvh_case(n_rays: int, n_tris: int, dead: bool = False):
    """(rays (6, n) on the card, DeviceBVH on the card) over random triangles
    in a 10-unit box, half the rays aimed at triangle centroids; ``dead``
    parks every ray at 1e9 with a zero segment."""
    g = np.random.default_rng(n_rays * 7 + n_tris)
    tris, _ = random_triangles(g, n_tris)
    o, s = random_segments(g, n_rays)
    if n_tris:
        aim = g.integers(0, n_tris, n_rays // 2)
        s[: n_rays // 2] = (tris[aim].mean(axis=1) - o[: n_rays // 2]) * 1.25
    if dead:
        o[:], s[:] = 1e9, 0.0
    rays = to_torch(np.concatenate([o, s], axis=1)).T.contiguous().cuda()
    flat = bvh.build_bvh(tris) if n_tris else bvh._build_bvh_py(tris, 4)
    return rays, bvh.DeviceBVH.from_flat(flat, geometry.triangle_soa(to_torch(tris)).cuda())


@pytest.mark.parametrize("n_rays,n_tris,dead", [(1, 700, False), (1000, 0, False),
                                                (300, 3, False), (500, 700, True),
                                                (2560, 2220, False), (1001, 700, False),
                                                (17, 2220, False), (20480, 2220, False)],
                         ids=["1 ray", "no triangle", "leaf only", "all dead", "2560 x 2220",
                              "1001 rays", "17 rays", "20480 x 2220"])
def test_bvh_kernel_matches_plain_bitwise(cuda, n_rays, n_tris, dead):
    """K11 against its plain version: t, winner and the per-ray node and test
    counts of the 4-wide walk bitwise; t and winner against the binary walk
    and against K1 bitwise. 1,001 and 17 rays fill no 16-ray block."""
    rays, device_bvh = _bvh_case(n_rays, n_tris, dead)
    before = bvh_intersect.launches
    t_k, j_k, c_k = bvh_intersect.bvh_best(rays, device_bvh, counts=True)
    torch.cuda.synchronize()
    assert bvh_intersect.launches == before + 1
    assert bvh_intersect.last_blocks == -(-n_rays // 16)
    t_p, j_p, c_p = bvh.bvh4_best_plain(rays, device_bvh, counts=True)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(j_k, j_p) and torch.equal(c_k, c_p)
    t_b, j_b = bvh.bvh_best_plain(rays, device_bvh)
    assert torch.equal(t_k.view(torch.int32), t_b.view(torch.int32)) and torch.equal(j_k, j_b)
    # K1 on the scene's triangles in their own order: the same (t, index)
    scene_soa = torch.empty_like(device_bvh.tri_soa)
    scene_soa[:, device_bvh.tri_order.long()] = device_bvh.tri_soa
    t_1, i_1 = intersect.intersect_best(rays, scene_soa)
    assert torch.equal(t_k, t_1) and torch.equal(j_k, i_1)
    assert torch.equal(bvh_intersect.bvh_best(rays, device_bvh)[0], t_k)  # without counts
    if dead or not n_tris:
        assert bool((t_k == geometry.NO_HIT_T).all()) and bool((j_k == 0).all())
        assert not bool(c_k.any())  # a dead ray visits nothing
    if n_tris == 3:
        assert device_bvh.nodes.shape[0] == 1 and device_bvh.nodes4.shape[0] == 1
    if n_rays >= 2560:
        assert int((t_k < 1.5).sum()) > n_rays // 4


def test_bvh_frame_on_the_card_equals_the_brute_frame(cuda):
    cfg = small_test_config()
    pack = load_and_compile(SPHERE_SCENE)
    frames = {}
    for name, kw in (("bvh", {"use_bvh": True}), ("brute", {"use_culled_intersect": False})):
        sim = Simulator(pack, cfg, device=cuda, seed=2, **kw)
        assert sim.intersect == name
        frames[name] = sim.render_frame(3)
    for key in ("rays", "valid", "to"):
        assert torch.equal(frames["bvh"]["segments"][key], frames["brute"]["segments"][key]), key
    assert torch.equal(frames["bvh"]["bmode"], frames["brute"]["bmode"])


def test_pose_fd_step_on_the_card_matches_the_cpu(cuda):
    """One fd step at a small config with two keys: the seven point losses
    (rtol 1e-4), the gradient (atol 1e-3 x its largest entry) and the pose
    after the step (atol 1e-5 on the strong axes) on the card against the CPU."""
    cfg = small_test_config(transducer_elements=32, samples_per_element=1)
    pack = load_and_compile(SPHERE_SCENE)
    keys = rng.split(rng.prng_key(42), 2)
    result = {}
    for device in ("cpu", cuda):
        sim = Simulator(pack, cfg, device=device, seed=0)
        render = lambda k, p, a, sim=sim: sim.render_frame(k, position=p, angles=a)["bmode"]
        with torch.no_grad():
            target = PoseFitter.compound(render, keys, sim.position, sim.angles)
        fit = PoseFitter.from_simulator(sim, sim.position.cpu() + torch.tensor([0.0, 0.3, 0.0]),
                                        sim.angles, target, method="fd", keys=keys,
                                        scales=(4.0, 8.0), learning_rate=2.5e-2)
        vals, g = fit.fd_gradient(0.06)
        fit.apply_fd_update(g)
        result[str(torch.device(device).type)] = (vals.cpu(), g.cpu(), fit.position.cpu())
    (v_c, g_c, p_c), (v_g, g_g, p_g) = result["cpu"], result["cuda"]
    np.testing.assert_allclose(v_g, v_c, rtol=1e-4)
    np.testing.assert_allclose(g_g, g_c, rtol=0, atol=1e-3 * float(g_c.abs().max()))
    strong = g_c.abs() > 0.01 * g_c.abs().max()
    np.testing.assert_allclose(p_g[strong], p_c[strong], atol=1e-5)


def _differing_frames(rows: int, cols: int, frames: int, seed: int) -> torch.Tensor:
    """(frames, rows, cols) noise images that differ: each its own scale, one
    with a falling column (no peak) and one with a plateau across the rows."""
    g = torch.Generator().manual_seed(seed)
    rf = torch.randn((frames, rows, cols), generator=g)
    rf *= torch.arange(1, frames + 1, dtype=torch.float32)[:, None, None]
    rf[0, :, 7] = torch.linspace(1.0, -1.0, rows)
    rf[-1, rows // 3 : rows // 2, :] = rf[-1, rows // 3 : rows // 3 + 1, :]
    return rf


@pytest.mark.parametrize("rows", [465, 1200, 2000])
def test_postproc_kernel_takes_a_frame_axis(cuda, rows):
    """K3 over B = 3 frames that differ in one launch (the grid's second axis
    is the frame): bitwise the kernel launched per frame, B = 1 bitwise the
    2-D call, and against its plain version over the stack at 1e-5 / 1e-6
    (bitwise at 1,200 rows, past a lane's mask, and at 2,000, where the
    strips' buffers are a device-memory slab per block of every frame)."""
    cfg = SimConfig()
    rf = _differing_frames(rows, 96, 3, rows).to(cuda)
    before = postproc.launches
    got = postproc.postproc_forward(rf, cfg)
    assert postproc.launches == before + 1
    assert postproc.last_blocks == 3 * (96 // 4)
    each = torch.stack([postproc.postproc_forward(rf[b], cfg) for b in range(3)])
    assert torch.equal(got, each)
    assert torch.equal(postproc.postproc_forward(rf[1:2], cfg)[0], each[1])
    want = postproc.postproc_plain(rf, cfg)
    if rows == 465:
        np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(got, want)
    slab = _build.library().mcray_postproc_slab_floats(rows, 96, 3, cfg.psf_lateral_size,
                                                       postproc.MAX_SHARED_BYTES)
    assert (slab > 0) == (rows == 2000)


def test_scan_kernels_take_a_frame_axis(cuda):
    """K4 and K9 over B = 3 frames that differ in one launch each: K4
    bitwise its plain versions over the stack and the kernel per frame; K9
    bitwise its CSR lists summed in order on the host, per frame, and the
    kernel per frame; B = 1 bitwise the 2-D call; the autograd Function
    routes a (B, H, W) cotangent through one K9 launch."""
    cfg = SimConfig()
    maps = scanconv.scan_maps(*imaging.scan_conversion_maps(cfg), cfg.rf_rows, cfg.rf_cols,
                              device=cuda)
    rf = _differing_frames(cfg.rf_rows, cfg.rf_cols, 3, 5).to(cuda)
    g = _differing_frames(cfg.bmode_rows, cfg.bmode_cols, 3, 6).to(cuda)
    n_pix = cfg.bmode_rows * cfg.bmode_cols
    before = scanconv.launches, scanconv.launches_bwd
    got = scanconv.scan_convert_forward(rf, maps)
    grad = scanconv.scan_convert_backward(g, maps)
    assert (scanconv.launches, scanconv.launches_bwd) == (before[0] + 1, before[1] + 1)
    assert scanconv.last_blocks == 3 * -(-n_pix // 128)
    assert scanconv.last_blocks_bwd == 3 * -(-cfg.rf_rows * cfg.rf_cols // 256)
    assert torch.equal(got, scanconv.scan_convert_coords_plain(rf, maps.coords))
    assert torch.equal(got, scanconv.scan_convert_plain(rf, maps.table, cfg.bmode_cols))
    for b in range(3):
        assert torch.equal(got[b], scanconv.scan_convert_forward(rf[b], maps))
        assert torch.equal(grad[b], scanconv.scan_convert_backward(g[b], maps))
    assert torch.equal(scanconv.scan_convert_forward(rf[2:], maps)[0], got[2])
    assert torch.equal(scanconv.scan_convert_backward(g[2:], maps)[0], grad[2])
    row_ptr, pixel, weight = (a.cpu().numpy() for a in (maps.row_ptr, maps.pixel, maps.weight))
    cell = np.repeat(np.arange(cfg.rf_rows * cfg.rf_cols), np.diff(row_ptr))
    for b in range(3):
        in_order = np.zeros(cfg.rf_rows * cfg.rf_cols, np.float32)
        np.add.at(in_order, cell, weight * g[b].cpu().numpy().reshape(-1)[pixel])
        np.testing.assert_array_equal(grad[b].cpu().numpy().reshape(-1), in_order)
    np.testing.assert_allclose(
        grad.cpu(), scanconv.scan_convert_bwd_plain(g, maps.table, cfg.rf_rows, cfg.rf_cols).cpu(),
        rtol=1e-5, atol=1e-6)
    x = rf.clone().requires_grad_(True)
    before = scanconv.launches_bwd
    (through,) = torch.autograd.grad(scanconv.scan_convert_cuda(x, maps), x, g)
    assert scanconv.launches_bwd == before + 1 and torch.equal(through, grad)
    with pytest.raises(ValueError):  # a frame of another shape
        scanconv.scan_convert_forward(rf[:, :, :-1].contiguous(), maps)


def test_batched_frame_on_the_card_equals_single_frames(cuda):
    """``render_frames`` of 3 seeds at 3 poses (log compression on: each
    frame's own maximum) on the card: one launch of K2, K3 and K4 and
    ``max_depth`` of K5, and every frame's rf_raw, rf_env and bmode bitwise
    ``render_frame``'s."""
    from mcray_tpu_torch.ops import cuda as kernels

    cfg = small_test_config(transducer_elements=32, samples_per_element=2, log_compression=True)
    sim = Simulator(load_and_compile(SPHERE_SCENE), cfg, device=cuda, seed=1)
    positions = sim.position + torch.tensor([[0.0, 0.0, 0.0], [0.1, 0.0, 0.0], [0.0, 0.2, 0.0]],
                                            device=cuda)
    angles = sim.angles + torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 3.0], [2.0, 0.0, 0.0]],
                                       device=cuda)
    kernels.reset_launch_counts()
    batch = sim.render_frames([1, 2, 3], positions=positions, angles=angles)
    counts = kernels.launch_counts()
    assert counts["intersect_listed"] == cfg.max_depth
    assert (counts["march"], counts["postproc"], counts["scanconv"]) == (1, 1, 1)
    for b, seed in enumerate((1, 2, 3)):
        one = sim.render_frame(seed, position=positions[b], angles=angles[b])
        for key in ("rf_raw", "rf_env", "bmode"):
            assert torch.equal(batch[key][b], one[key]), (key, b)


def test_batched_fd_and_fit_steps_on_the_card_equal_their_loops(cuda):
    """The pose fd step through ``from_simulator`` (7 points x 2 keys in one
    batched call) against the per-point loop: losses, gradient and the pose
    after the update bitwise. A 2-frame fit step (one batched call, K8 and
    K9 once) against the loop of frames: the loss bitwise, the gradient
    within 1e-5 of its largest entry (another summation order, and the
    card's gather backward adds with atomics)."""
    from mcray_tpu_torch.models.trainer import MaterialFitter
    from mcray_tpu_torch.ops import cuda as kernels

    pack = load_and_compile(SPHERE_SCENE)
    cfg = small_test_config(transducer_elements=32, samples_per_element=1)
    sim = Simulator(pack, cfg, device=cuda, seed=0)
    keys = rng.split(rng.prng_key(42), 2)
    render = lambda k, p, a: sim.render_frame(k, position=p, angles=a)["bmode"]
    with torch.no_grad():
        target = sim.render_compound(keys)
    start = sim.position + torch.tensor([0.0, 0.3, 0.0], device=cuda)
    kw = dict(method="fd", keys=keys, scales=(4.0, 8.0))
    batched = PoseFitter.from_simulator(sim, start, sim.angles, target, **kw)
    looped = PoseFitter(render, start, sim.angles, target, **kw)
    kernels.reset_launch_counts()
    got = batched.fd_step(0)
    assert kernels.launch_counts()["intersect_listed"] == cfg.max_depth
    want = looped.fd_step(0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(batched.position, looped.position)

    fcfg = small_test_config(transducer_elements=32, samples_per_element=2,
                             soft_scattering=True, trilinear_texture=True)
    fsim = Simulator(pack, fcfg, device=cuda, seed=1)
    with torch.no_grad():
        ftarget = fsim.render_frame(1)["bmode"]
    start_m = pack.materials.copy()
    start_m[3, physics.ATTENUATION] *= 2.0
    fkw = dict(trainable=(physics.ATTENUATION,), trainable_rows=[3], n_frames_per_step=2)
    fit = MaterialFitter.from_simulator(fsim, start_m, ftarget, **fkw)
    loop = MaterialFitter(lambda k, m: fsim.render_frame(k, m)["bmode"],
                          torch.tensor(start_m, device=cuda), ftarget, **fkw)
    kernels.reset_launch_counts()
    loss = fit.step(rng.prng_key(2))
    counts = kernels.launch_counts()
    assert (counts["march"], counts["march_bwd"], counts["scanconv_bwd"]) == (1, 1, 1)
    assert loop.step(rng.prng_key(2)) == loss
    scale = float(loop.last_grad.abs().max())
    assert scale > 0
    np.testing.assert_allclose(fit.last_grad.cpu(), loop.last_grad.cpu(), rtol=0,
                               atol=1e-5 * scale)


def test_serve_drain_waits_on_the_previous_frame_only(cuda, tmp_path, monkeypatch, capsys):
    """While frame i - 1 drains, a device-wide wait raises, the only event
    waited on is frame i - 1's, and frame i (held on the card by a ~0.2 s
    spin queued after its launches) is still pending when the drain
    returns: the drain overlaps frame i and waits on nothing of it."""
    from mcray_tpu_torch import cli

    staged, drains = [], []
    stage, drain, event_sync = cli._stage, cli._drain, torch.cuda.Event.synchronize

    def slow_stage(bmode):
        torch.cuda._sleep(400_000_000)  # ~0.2 s: this frame's copy and event wait behind it
        out = stage(bmode)
        staged.append(out[1])
        return out

    def no_device_wait(*args, **kwargs):
        raise AssertionError("the drain waited on the whole device")

    def watched_drain(frame):
        waited = []
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "synchronize", no_device_wait)
            m.setattr(torch.cuda.Stream, "synchronize", no_device_wait)
            m.setattr(torch.cuda.Event, "synchronize",
                      lambda ev: (waited.append(ev), event_sync(ev))[1])
            drain(frame)
        newest = staged[-1]
        drains.append((waited == [frame[1]], newest is frame[1] or not newest.query()))

    monkeypatch.setattr(cli, "_stage", slow_stage)
    monkeypatch.setattr(cli, "_drain", watched_drain)
    monkeypatch.setattr("sys.stdin", io.StringIO("{}\n{}\n{}\n"))
    assert cli.main(["serve", SPHERE_SCENE, "--elements", "32", "--samples", "1",
                     "--out-prefix", str(tmp_path / "serve")]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert len([x for x in lines if "frame" in x]) == 3 and len(drains) == 3
    # every drain waited on its own frame's event alone; the two that ran
    # beside a newer frame returned with that frame still pending
    assert drains == [(True, True)] * 3


def test_render_rf_conv_on_the_card(cuda):
    """Where K3 runs it fuses the convolution: ``rf_conv`` is ``rf_raw``, as
    on the reference's fused path; under the centered PSF the plain postproc
    runs and ``rf_conv`` is the convolved image."""
    pack = load_and_compile(SPHERE_SCENE)
    out = Simulator(pack, small_test_config(), device=cuda).render_frame(0)
    assert out["rf_conv"] is out["rf_raw"]
    cfg = small_test_config(centered_psf=True)
    out = Simulator(pack, cfg, device=cuda).render_frame(0)
    torch.testing.assert_close(out["rf_conv"], imaging.convolve_psf(out["rf_raw"], cfg),
                               rtol=0, atol=0)
    assert out["segments_valid"].dtype == torch.bool


def test_frame_metrics_wait_for_the_card(cuda, monkeypatch):
    from mcray_tpu_torch.utils.profiling import FrameMetrics

    waits = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: waits.append(device))
    metrics = FrameMetrics()
    with metrics.stage("frame", sync={"bmode": torch.ones(2, device=cuda), "cpu": torch.ones(2)}):
        pass
    assert waits == [torch.ones(1, device=cuda).device]


def test_sharded_frame_on_a_one_rank_nccl_group(cuda):
    """``make_mesh(device="cuda")`` starts a one-rank NCCL group; the sharded
    frame's RF equals the Simulator's bitwise, the gathered B-mode too (the
    same K3), the halo B-mode at rtol 1e-5 / atol 1e-6 (plain against K3)."""
    import torch.distributed as dist

    from mcray_tpu_torch.parallel.shard import ShardedRenderer, make_mesh

    pack = load_and_compile(SPHERE_SCENE)
    cfg = small_test_config()
    want = Simulator(pack, cfg, device=cuda).render_frame(2)
    try:
        mesh = make_mesh(device="cuda")
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        for halo in (True, False):
            got = ShardedRenderer(pack, cfg, mesh, distributed_imaging=halo).render_frame(2)
            assert torch.equal(got["rf_raw"], want["rf_raw"])
            tol = {"rtol": 1e-5, "atol": 1e-6} if halo else {"rtol": 0, "atol": 0}
            torch.testing.assert_close(got["bmode"], want["bmode"], **tol)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_cuda_mesh_raises_without_nccl(cuda, monkeypatch):
    import torch.distributed as dist

    from mcray_tpu_torch.parallel.shard import make_mesh

    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        make_mesh(device="cuda")
    assert not dist.is_initialized()


def test_graph_ms_and_busy_view_of_one_scanconv_launch(cuda):
    """The measuring layer on one K4 launch: a positive device time by graph
    replay and by the profiler, which sees the launch as one operation."""
    from mcray_tpu_torch.utils import benchmarking

    cfg = small_test_config()
    maps = scanconv.scan_maps(*imaging.scan_conversion_maps(cfg), cfg.rf_rows, cfg.rf_cols,
                              device=cuda)
    rf = to_torch(np.random.default_rng(5).random((cfg.rf_rows, cfg.rf_cols), np.float32)).to(cuda)

    def launch():
        return scanconv.scan_convert_forward(rf, maps)

    assert benchmarking.graph_ms(launch, 1) > 0.0
    view = benchmarking.busy_view(launch, 3, expect={"scan_convert_kernel": 1})
    assert view["busy_ms"] > 0.0 and view["operations"] == 1


def test_stage_table_of_a_small_sphere_frame(cuda):
    """The stage table of a small sphere frame: its five stages, each timed,
    and the frame's floor a share of its busy time in (0, 100]."""
    from mcray_tpu_torch.utils import roofline

    sim = Simulator(load_and_compile(SPHERE_SCENE), small_test_config(), device=cuda)
    table = roofline.stage_table(sim, [0])
    assert [r["stage"] for r in table["stages"]] == ["draws", "trace", "march", "postproc", "scan_convert"]
    assert all(r["ms"] > 0.0 and r["n_ops"] > 0 for r in table["stages"])
    assert 0.0 < table["frame_pct_of_roofline"] <= 100.0
    assert table["full_frame_ms"] > 0.0 and table["frame_operations"] > 0


def test_chained_batch_replay_equals_the_eager_steps(cuda):
    """``make_chained_batch(2, 3)`` replayed from a CUDA graph against its
    steps run eagerly on the card, and its last step (keys derived on the
    card) against ``render_frames`` of its keys made on the host, bitwise; a second
    call with another seed0 gives that seed's frames (the graph holds no
    stale key); the replays launch K5, K2, K3 and K4 as the eager steps do
    (the profiler's operations by kernel name)."""
    from mcray_tpu_torch.utils import benchmarking

    cfg = small_test_config(transducer_elements=32, samples_per_element=2)
    sim = Simulator(load_and_compile(SPHERE_SCENE), cfg, device=cuda, seed=1)
    chained = sim.make_chained_batch(2, 3)
    eager = sim.make_chained_batch(2, 3)  # its steps, called one by one without a graph

    def eager_steps(seed0):
        eager.key.copy_(rng.prng_key(seed0))
        eager.i.zero_()
        eager.carry.zero_()
        return [eager.step() for _ in range(3)]

    for seed0 in (3, 11):
        got = chained(seed0).clone()
        steps = eager_steps(seed0)
        assert chained.graph is not None and int(chained.carry) == 0 and int(chained.i) == 3
        assert torch.equal(got, steps[-1])
        keys = rng.fold_in(rng.prng_key(seed0), 4 + torch.arange(2))
        assert torch.equal(got, sim.render_frames(keys)["bmode"])
    assert not torch.equal(steps[0], steps[-1])
    view = benchmarking.busy_view(lambda: chained(5), 1, expect={
        "intersect_listed_kernel": 3 * cfg.max_depth, "march_kernel": 3, "postproc_kernel": 3,
        "scan_convert_kernel": 3})
    assert view["busy_ms"] > 0.0


def test_chained_call_marks_every_stage_and_counts_its_replays(cuda):
    """A ``make_chained_batch(2, 3)`` call under the profiler: ``draws``,
    ``march`` and ``image`` once a step, ``prepass`` and
    ``closest_hit`` once a bounce, ``bounce_physics`` once a bounce and once
    before the first; ``launch_counts()`` counts each replay's launches (K5
    a bounce, K2, K3, K4 once); the step graph's nodes are counted once, and
    the call's B-modes are bitwise its steps run eagerly, where no mark
    launches."""
    from torch.profiler import ProfilerActivity, profile

    from mcray_tpu_torch.ops import cuda as kernels
    from mcray_tpu_torch.utils import profiling

    cfg = small_test_config(transducer_elements=32, samples_per_element=2)
    sim = Simulator(load_and_compile(SPHERE_SCENE), cfg, device=cuda, seed=1)
    chained = sim.make_chained_batch(2, 3)
    nodes = profiling.counters().get("chained.graph_nodes", 0)
    chained(1)  # the capture
    assert profiling.counters()["chained.graph_nodes"] > nodes
    assert chained.launches == {"intersect_listed": cfg.max_depth, "march": 1, "postproc": 1,
                                "scanconv": 1}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = chained(9).clone()
        torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    assert counts == {k: 3 * v for k, v in chained.launches.items()}
    marks = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "mcray_mark_" in e.name:
            stage = e.name.split("mcray_mark_", 1)[1].split("(")[0]
            marks[stage] = marks.get(stage, 0) + 1
    d = cfg.max_depth
    assert marks == {"draws": 3, "prepass": 3 * d, "closest_hit": 3 * d,
                     "bounce_physics": 3 * (d + 1), "march": 3, "image": 3}

    eager = sim.make_chained_batch(2, 3)
    eager.key.copy_(rng.prng_key(9))
    eager.i.zero_()
    eager.carry.zero_()
    kernels.reset_launch_counts()
    steps = [eager.step() for _ in range(3)]
    assert torch.equal(got, steps[-1])
    assert {k: v for k, v in kernels.launch_counts().items() if v} == counts
    call, = [s for s in profiling.spans() if s.name == "chained.call" and s.profiled][-1:]
    replays = [s for s in profiling.spans() if s.name == "chained.replay"
               and s.request == call.request]
    assert len(replays) == 3
    assert all(s.parent == call.id and s.units == 2 for s in replays)
