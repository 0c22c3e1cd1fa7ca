"""The port's measuring layer (``utils/roofline.py``, ``utils/benchmarking.py``)
on the CPU, at ``small_test_config()`` sizes (~18 s in all on one thread).

Each per-kernel floor is held to an independent count written here in
numpy (float64 where a slab test or a time window decides, but the cluster
kernels' slab test against a ray's final t, whose ties the kernels decide in
float32: see the test); a frame's stage
floors are the same for every closest-hit mode, given the same rays; the
postproc's bytes are the reference's. Operation counts are not compared with
the reference's: it counts its TPU formulation (the envelope's log-step
scans, the scan conversion's one-hot matmuls), the port the work the
function needs. Everything that times the card raises here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_port import SPHERE_SCENE, both_configs, to_np
from mcray_tpu.utils import roofline as ref_roofline
from mcray_tpu_torch.config import small_test_config
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.ops import clusters, imaging
from mcray_tpu_torch.ops.cuda import intersect, intersect_grouped, march
from mcray_tpu_torch.scene.compile import load_and_compile
from mcray_tpu_torch.utils import benchmarking, roofline

SEED = 3
MODES = {"listed": {}, "culled": {"intersect_mode": "culled"},
         "staged": {"intersect_mode": "staged"}, "brute": {"use_culled_intersect": False},
         "bvh": {"use_bvh": True}}


@pytest.fixture(scope="module")
def frames():
    """The sphere at 32 elements x 2 paths in each closest-hit mode, and each
    mode's frame of SEED."""
    pack = load_and_compile(SPHERE_SCENE)
    cfg = small_test_config(transducer_elements=32, samples_per_element=2)
    sims = {mode: Simulator(pack, cfg, device="cpu", **kw) for mode, kw in MODES.items()}
    return sims, {mode: sim.render_frame(seed=SEED) for mode, sim in sims.items()}


def _bounces(out):
    rays = out["segments"]["rays"]
    return [rays[d].contiguous() for d in range(rays.shape[0])]


def _live(rays: np.ndarray) -> np.ndarray:
    return np.abs(rays[3:6]).sum(axis=0) > 0


def _slab(o, s, boxes, dtype=np.float64):
    """(enter, leave), each (rays, boxes), in ``dtype``: the kernels' slab
    test with a zero direction component's inverse set to clusters.BIG."""
    o, s, boxes = (np.asarray(a, dtype) for a in (o, s, boxes))
    inv = np.where(np.abs(s) > 1e-30, dtype(1.0) / np.where(s == 0, dtype(1.0), s),
                   dtype(clusters.BIG))
    with np.errstate(over="ignore"):  # BIG x an offset overflows to inf, as in torch
        t0 = (boxes[None, :, 0:3] - o[:, None]) * inv[:, None]
        t1 = (boxes[None, :, 3:6] - o[:, None]) * inv[:, None]
    return np.minimum(t0, t1).max(axis=2), np.maximum(t0, t1).min(axis=2)


def _check_bound(got, n_bytes, n_ops):
    assert (got.n_bytes, got.n_ops) == (n_bytes, n_ops)
    by_bytes, by_ops = n_bytes / 3.35e12 * 1e3, n_ops / 67e12 * 1e3
    assert tuple(got) == ((by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations"))


def test_summarize_gives_the_reference_keys_on_the_h100_peaks():
    cost = roofline.StageCost("march", flops=6.7e9, hbm_bytes=3.35e9)
    row = cost.summarize(0.5)
    want = ref_roofline.StageCost("march", 6.7e9, 3.35e9, "vpu").summarize(0.5)
    assert set(row) == set(want)
    assert row["stage"] == "march" and row["unit"] == "f32" and row["bound"] == "bandwidth"
    np.testing.assert_allclose(
        [row[k] for k in ("ms", "gflops", "hbm_mb", "effective_tflops", "pct_peak_compute",
                          "effective_gbps", "pct_peak_hbm", "roofline_ms")],
        # 6.7 GFLOP and 3.35 GB in 0.5 s: 13.4 GFLOP/s of 67 TFLOP/s, 6.7 GB/s of 3.35 TB/s;
        # the floor is the bytes' 1 ms against the operations' 0.1 ms
        [500.0, 6.7, 3350.0, 0.0134, 0.02, 6.7, 0.2, 1.0], rtol=1e-12)
    assert cost.floor() == (1.0, "bytes")
    heavy = roofline.StageCost("scan_convert", flops=1.34e12, hbm_bytes=3.35e9, useful_flops=6.7e10)
    row = heavy.summarize(0.1)
    assert set(row) == set(ref_roofline.StageCost("s", 1.0, 1.0, "mxu", useful_flops=1.0)
                           .summarize(1.0))
    assert row["bound"] == "compute" and row["roofline_ms"] == pytest.approx(20.0)
    assert row["formulation_overhead_x"] == pytest.approx(20.0)
    assert heavy.floor() == (pytest.approx(20.0), "operations")


def test_brute_bound_counts_every_live_ray_against_every_triangle(frames):
    sims, outs = frames
    rays, tri_soa = _bounces(outs["brute"]), sims["brute"].scene["tri_soa"]
    t = tri_soa.shape[1]
    n_bytes = sum(r.shape[1] * 6 * 4 + t * 9 * 4 + 8 * r.shape[1] for r in rays) / len(rays)
    n_ops = sum(int(_live(to_np(r)).sum()) * t * 50 for r in rays) / len(rays)
    assert n_ops > 0
    _check_bound(roofline.brute_bound(rays, tri_soa), n_bytes, n_ops)


@pytest.mark.parametrize("mode", ["listed", "culled"])
def test_cluster_bound_counts_the_clusters_each_ray_enters_before_its_final_t(frames, mode):
    sims, outs = frames
    packed = sims[mode].culled_tris[0]
    tile_r = sims[mode].intersect_tile_r
    boxes = to_np(packed.aabb_cluster)[:, :6]
    launches, n_bytes, n_ops = [], 0, 0
    for r in _bounces(outs[mode]):
        o, s = r[0:3].T.contiguous(), r[3:6].T.contiguous()
        op, sp, padded = clusters.pad_rays(o, s, tile_r)
        best_t, _ = intersect.intersect_best(padded, sims["brute"].scene["tri_soa"])
        lists = clusters.packet_cluster_lists(op, sp, packed, tile_r) if mode == "listed" else ()
        launches.append((padded, best_t, lists))
        p, t = to_np(padded), to_np(best_t)
        live = _live(p)
        # in float32, as the kernels test it: the first bounce's rays hit the
        # scene's box on the face where they enter it, so a cluster's entry
        # equals their final t in f32 (not needed: entry < t is strict), while
        # float64 places the entry an ulp of t before the f32-rounded t
        enter, leave = _slab(p[0:3, live].T, p[3:6, live].T, boxes, np.float32)
        need = (enter <= leave) & (leave > 0.0) & (enter < np.minimum(t[live], 1.0)[:, None])
        n_ops += int(need.sum()) * packed.tile_t * 50
        n_bytes += (p.size * 4 + sum(a.numel() * a.element_size() for a in lists)
                    + 8 * p.shape[1] + int(need.any(axis=0).sum()) * (9 * packed.tile_t + 8) * 4)
    assert n_ops > 0
    _check_bound(roofline.cluster_bound(packed, launches), n_bytes / len(launches),
                 n_ops / len(launches))


def test_grouped_bound_counts_the_tables_incidences(frames):
    sims, outs = frames
    packed = sims["listed"].culled_tris[0]
    boxes = to_np(packed.aabb_cluster)[:, :6]
    launches, n_bytes, n_ops = [], 0, 0
    for r in _bounces(outs["listed"]):
        op, sp, padded = clusters.pad_rays(r[0:3].T.contiguous(), r[3:6].T.contiguous(), 128, 1e9)
        hit, _ = clusters.ray_cluster_hits(op, sp, packed)
        ray_ids, counts, _ = clusters.cluster_ray_tables(hit, intersect_grouped.GROUP_G,
                                                         intersect_grouped.CHUNK_G)
        launches.append((padded, ray_ids, counts, packed))
        # each live ray's slab test inside its segment, then the tables' budget:
        # of each 128-ray chunk a cluster keeps its first CHUNK_G rays, of those its first g
        p = to_np(padded)
        live = _live(p)
        enter, leave = _slab(p[0:3].T, p[3:6].T, boxes)
        hit64 = (enter <= leave) & (leave > 0.0) & (enter < 1.0) & live[:, None]
        g = clusters.group_width(p.shape[1], intersect_grouped.GROUP_G, intersect_grouped.CHUNK_G)
        per_chunk = hit64.reshape(-1, 128, boxes.shape[0]).sum(axis=1)
        kept = np.minimum(np.minimum(per_chunk, intersect_grouped.CHUNK_G).sum(axis=0), g)
        n_ops += int(kept.sum()) * packed.tile_t * 50
        n_bytes += (p.size * 4 + boxes.shape[0] * 4 + 4 * int(kept.sum()) + 8 * p.shape[1]
                    + int((kept > 0).sum()) * 9 * packed.tile_t * 4)
    assert n_ops > 0
    _check_bound(roofline.grouped_bound(launches), n_bytes / len(launches), n_ops / len(launches))


def test_march_floor_counts_the_steps_inside_the_window(frames):
    sims, outs = frames
    cfg, soa = sims["listed"].cfg, outs["listed"]["soa"]
    # every segment's steps walked one by one in float64: t0 + k dt before the window closes
    f = to_np(soa)[:, :, : cfg.rf_cols].astype(np.float64)
    t0, steps = f[:, march.F_T0], f[:, march.F_STEPS]
    valid = f[:, march.F_VALID] > 0.5
    k = np.arange(int(np.ceil(float(cfg.max_travel_time_us) / cfg.march_dt_us)) + 1)  # t0 >= 0
    inside = (k < steps[..., None]) & (t0[..., None] + k * cfg.march_dt_us
                                      < float(cfg.max_travel_time_us))
    matched = int((inside & valid[..., None]).sum())
    assert 0 < matched < int((steps * valid).sum())  # the window cuts some segments
    assert roofline.matched_steps(soa, cfg, cfg.rf_cols) == matched
    n_rf_bytes = 4 * cfg.rf_rows * cfg.rf_cols
    cost = roofline.march_cost(soa, cfg, cfg.rf_cols)
    assert (cost.flops, cost.hbm_bytes) == (matched * 70, soa.numel() * 4 + n_rf_bytes)
    bwd = roofline.march_bwd_cost(soa, cfg, cfg.rf_cols)
    assert (bwd.flops, bwd.hbm_bytes) == (matched * 100, 2 * soa.numel() * 4 + n_rf_bytes)


def test_scan_floors_count_the_image_the_maps_and_the_taps(frames):
    sims, _ = frames
    sim = sims["listed"]
    cfg, maps = sim.cfg, sim.scan_maps
    n_rf, n_bm = cfg.rf_rows * cfg.rf_cols, cfg.bmode_rows * cfg.bmode_cols
    row, col = imaging.scan_conversion_maps(cfg)
    assert tuple(row.shape) == tuple(col.shape) == (cfg.bmode_rows, cfg.bmode_cols)
    for frames_ in (1, 3):
        k4 = roofline.scanconv_cost(cfg, frames_)
        assert (k4.flops, k4.hbm_bytes) == (11 * frames_ * n_bm,
                                            4 * frames_ * n_rf + 8 * n_bm + 4 * frames_ * n_bm)
        taps = maps.pixel.numel()
        k9 = roofline.scanconv_bwd_cost(cfg, taps, frames_)
        assert (k9.flops, k9.hbm_bytes) == (2 * frames_ * taps,
                                            4 * frames_ * (n_bm + n_rf) + 8 * n_bm)
    # every tap is a bilinear weight of one B-mode pixel: at most 4 a pixel
    assert 0 < maps.pixel.numel() <= 4 * n_bm
    wide = torch.zeros(3, 5)
    _check_bound(roofline.copy_bound(wide), 2 * 60, 0)


def test_frame_costs_are_the_same_for_every_closest_hit_mode(frames):
    sims, outs = frames
    costs = {mode: roofline.frame_costs(sims[mode], outs["listed"]) for mode in MODES}
    want = {name: (c.flops, c.hbm_bytes) for name, c in costs["listed"].items()}
    assert list(want) == ["draws", "trace", "march", "postproc", "scan_convert"]
    for mode, c in costs.items():
        assert {name: (s.flops, s.hbm_bytes) for name, s in c.items()} == want, mode
    # each mode's own frame traces the same rays, so it has the same floors
    for mode, out in outs.items():
        assert torch.equal(out["segments"]["rays"], outs["listed"]["segments"]["rays"]), mode
        own = roofline.frame_costs(sims[mode], out)["trace"]
        assert (own.flops, own.hbm_bytes) == want["trace"], mode
    # the trace's closest hit is the reference walk's: fewer tests than the brute count
    walks = roofline.reference_walks(outs["bvh"]["segments"]["rays"], sims["bvh"].bvh)
    walk = roofline.bvh_bound(walks, sims["bvh"].bvh)
    brute = roofline.brute_bound(_bounces(outs["brute"]), sims["brute"].scene["tri_soa"])
    assert 0 < walk.n_ops < brute.n_ops
    trace = costs["bvh"]["trace"]
    segments = outs["listed"]["segments"]
    live = int(segments["valid"].sum())
    fields = sum(segments[k].numel() * segments[k].element_size() for k in roofline.SEGMENT_FIELDS)
    assert trace.flops == walk.n_ops * len(walks) + live * roofline.OPS_BOUNCE
    assert trace.hbm_bytes == walk.n_bytes * len(walks) + 5 * 4 * segments["valid"].numel() + fields
    # given walks: used as they are, and refused when they are of other rays
    given = roofline.frame_costs(sims["listed"], outs["listed"], walks=walks, bvh=sims["bvh"].bvh)
    assert (given["trace"].flops, given["trace"].hbm_bytes) == want["trace"]
    with pytest.raises(ValueError, match="not of this frame's rays"):
        roofline.frame_costs(sims["listed"], outs["listed"], walks=walks[:-1])


def test_frame_costs_of_a_batch_count_every_frame(frames):
    sims, _ = frames
    sim = sims["brute"]
    cfg = sim.cfg
    out = sim.render_frames([SEED, SEED + 1])
    costs = roofline.frame_costs(sim, out)
    one = roofline.frame_costs(sim, sim.render_frame(seed=SEED))
    paths = cfg.transducer_elements * cfg.samples_per_element
    draws = cfg.max_depth * 2 * paths
    assert costs["draws"].flops == ((2 * paths + 13 * draws) * roofline.OPS_THREEFRY
                                    + draws * (5 * 3 + 35))
    assert costs["draws"].hbm_bytes == 2 * 16 + 5 * 4 * draws
    for name in ("postproc", "scan_convert"):
        assert costs[name].flops == 2 * one[name].flops
    assert costs["march"].hbm_bytes == out["soa"].numel() * 4 + 4 * cfg.rf_rows * 2 * cfg.rf_cols
    assert costs["trace"].flops > one["trace"].flops


@pytest.mark.parametrize("small", [True, False], ids=["small_test_config", "SimConfig"])
def test_postproc_bytes_are_the_references(small):
    ref_cfg, cfg = both_configs(small=small)
    assert roofline.postproc_cost(cfg).hbm_bytes == ref_roofline.postproc_cost(ref_cfg).hbm_bytes
    assert roofline.postproc_cost(cfg, 4).hbm_bytes == 4 * ref_roofline.postproc_cost(
        ref_cfg).hbm_bytes


def test_stage_table_raises_on_a_cpu_simulator(frames):
    sims, _ = frames
    with pytest.raises(RuntimeError, match="CUDA device"):
        roofline.stage_table(sims["listed"], [0])


@pytest.mark.parametrize("call", [
    lambda: benchmarking.cuda_ms(lambda: None, 3),
    lambda: benchmarking.event_ms(lambda: None, 3),
    lambda: benchmarking.graph_ms(lambda: None, 1),
    lambda: benchmarking.cold_graph_ms(lambda: None),
    lambda: benchmarking.busy_view(lambda: None),
    lambda: benchmarking.grid_sample_remap(torch.zeros(4, 5), torch.zeros(4, 5), 10, 8),
], ids=["cuda_ms", "event_ms", "graph_ms", "cold_graph_ms", "busy_view", "grid_sample_remap"])
def test_every_timing_function_raises_without_a_card(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        call()
