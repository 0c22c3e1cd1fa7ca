"""The floor of a frame's work on one NVIDIA H100, frozen with the benchmark.

Peaks: the H100 SXM data sheet's 3.35 TB/s of device memory and 67 TFLOP/s
of plain f32 outside the tensor cores (every stage computes in f32). A
stage's floor is the larger of its bytes over the memory rate and its
operations over the f32 rate; the frame's floor is the sum over its five
stages, each counting its inputs read once, its outputs written once and
the operations its inputs need:

- draws: the threefry cipher calls of the keyed draws and the five fields
  made floats;
- trace: the closest hit of every bounce's rays as the reference BVH walk
  does it (nodes popped x a slab test, triangles tested x Moller-Trumbore,
  the distinct nodes and triangles touched read once), whatever closest hit
  the program runs, and OPS_BOUNCE operations of physics a live
  path-bounce; the draws read and the segment fields written;
- march: the march steps inside the time window; the packed segments read,
  the RF image written;
- postproc: the two tap sums and the envelope a cell; the image read and
  written;
- scan conversion: a 4-tap bilinear lookup a pixel; the image and the two
  coordinate maps read, the B-mode written.

``EVENT_NAMES`` are the device event names of the program's hand-written
kernels.
"""

from __future__ import annotations

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
OPS_MOLLER_TRUMBORE = 50
OPS_SLAB_NODE = 26
OPS_HASH_PAIR = 40
OPS_MARCH_STEP = OPS_HASH_PAIR + 30
OPS_POSTPROC_CELL = 2 * (7 + 13) + 10
OPS_SCANCONV_PIXEL = 11
OPS_THREEFRY = 20 * 5 + 2 + 5 * 3
OPS_UNIFORM = 3
OPS_NORMAL = 35
CIPHERS_PER_BOUNCE = 13
DRAW_FIELDS = 5
OPS_BOUNCE = 270
SEGMENT_FIELDS = ("from", "to", "direction", "reflected", "initial", "attenuation", "distance",
                  "media_id", "valid")
TILE_C = 128
SOA_FIELDS = 16
STACK_DEPTH = 64
LEAF_SIZE = 4
BOX_PAD = 1e-5
NO_HIT_T = 2.0
EVENT_NAMES = {"intersect": "intersect_closest_kernel",
               "intersect_listed": "intersect_listed_kernel",
               "intersect_culled": "intersect_culled_kernel",
               "intersect_staged": "intersect_staged_kernel",
               "intersect_grouped": "intersect_grouped_kernel",
               "bvh_intersect": "bvh4_quad_kernel",
               "march": "march_kernel", "postproc": "postproc_kernel",
               "scanconv": "scan_convert_kernel", "march_bwd": "march_bwd_kernel",
               "scanconv_bwd": "scanconv_bwd_kernel"}


def floor_ms(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_OPS_PER_S) * 1e3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Tree:
    """The flat BVH on a device as the reference walk reads it: boxes
    padded by BOX_PAD of the scene's extent, triangles in the BVH order."""

    def __init__(self, nodes, meta, order, tris, device):
        nodes = np.asarray(nodes, np.float32)
        pad = np.float32(BOX_PAD * max(1.0, float(np.abs(nodes).max(initial=0.0))))
        boxes = np.concatenate([nodes[:, :3] - pad, nodes[:, 3:] + pad], axis=1)
        tris = np.asarray(tris, np.float32)
        v0, e1, e2 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
        soa = np.concatenate([v0, e1, e2], axis=1).T[:, np.asarray(order)]
        self.nodes = torch.as_tensor(boxes, device=device)
        self.meta = torch.as_tensor(np.asarray(meta, np.int32), device=device)
        self.order = torch.as_tensor(np.asarray(order, np.int32), device=device)
        self.soa = torch.as_tensor(np.ascontiguousarray(soa), device=device)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _moller_trumbore(origin, seg, v0, e1, e2, eps: float = 1e-9):
    pvec = _cross(seg, e2)
    det = _dot(e1, pvec)
    det_ok = torch.abs(det) > eps
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, torch.ones_like(det)), 0.0)
    tvec = origin - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(seg, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    return t, det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0) & (t < 1.0)


def walk(rays: torch.Tensor, tree: Tree):
    """The reference walk of (6, N) rays: per ray the nodes popped and the
    triangles tested, (2, N), and the masks of the nodes and triangles (BVH
    position) any ray touched. A node is entered where the segment enters
    its box before min(best t, 1); an inner node pushes its right, then its
    left child; the least (t, triangle index) wins."""
    n, t_total = rays.shape[1], tree.soa.shape[1]
    device = rays.device
    best_t = torch.full((n,), NO_HIT_T, dtype=torch.float32, device=device)
    best_i = torch.zeros(n, dtype=torch.int32, device=device)
    popped = torch.zeros(n, dtype=torch.int32, device=device)
    tested = torch.zeros(n, dtype=torch.int32, device=device)
    seen_nodes = torch.zeros(tree.nodes.shape[0], dtype=torch.bool, device=device)
    seen_tris = torch.zeros(t_total, dtype=torch.bool, device=device)
    origin, seg = rays[0:3].T, rays[3:6].T
    inv_seg = torch.where(seg.abs() > 1e-30, 1.0 / seg, 1e30)
    v0, e1, e2 = tree.soa[0:3].T, tree.soa[3:6].T, tree.soa[6:9].T
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int32, device=device)
    sp = torch.ones(n, dtype=torch.int32, device=device)
    top = STACK_DEPTH - 1
    while True:
        active = sp > 0
        if not bool(active.any()):
            break
        sp = sp - active.int()
        node = stack.gather(1, sp.clamp(0, top).long()[:, None])[:, 0].long()
        box = tree.nodes[node]
        m = tree.meta[node]
        ta = (box[:, 0:3] - origin) * inv_seg
        tb = (box[:, 3:6] - origin) * inv_seg
        enter = torch.amax(torch.minimum(ta, tb), dim=-1)
        leave = torch.amin(torch.maximum(ta, tb), dim=-1)
        hit_box = active & (enter <= leave) & (leave > 0.0) & (enter < torch.clamp(best_t,
                                                                                    max=1.0))
        visit = hit_box & (m[:, 1] >= 0)
        for k in range(LEAF_SIZE):
            j = torch.clamp(m[:, 0] + k, max=t_total - 1).long()
            t, valid = _moller_trumbore(origin, seg, v0[j], e1[j], e2[j])
            take = visit & (k < m[:, 1])
            tested += take.int()
            seen_tris[j[take]] = True
            idx = tree.order[j]
            take = take & valid & ((t < best_t) | ((t == best_t) & (idx < best_i)))
            best_t = torch.where(take, t, best_t)
            best_i = torch.where(take, idx, best_i)
        push = hit_box & (m[:, 1] < 0)
        for slot, value in ((sp, m[:, 0]), (sp + 1, node.int() + 1)):
            idx = slot.clamp(0, top).long()[:, None]
            stack.scatter_(1, idx, torch.where(push, value, stack.gather(1, idx)[:, 0])[:, None])
        sp = sp + 2 * push.int()
        popped += active.int()
        seen_nodes[node[active]] = True
    return torch.stack([popped, tested]), (seen_nodes, seen_tris)


def stage_costs(segments: dict, tree: Tree, p: dict) -> dict[str, tuple[float, float]]:
    """(bytes, operations) of each stage of the frames of ``segments`` (the
    (D, B x N) fields and the per-bounce ``rays``), ``p`` the acquisition."""
    d, n = segments["valid"].shape
    elements, samples = p["transducer_elements"], p["samples_per_element"]
    frames = n // (elements * samples)
    axial_mm = 1.45 / p["transducer_frequency"]
    axial_um = int(axial_mm * 1000.0)
    window_us = int(p["ultrasound_depth_cm"] * 1e4 / p["speed_of_sound"])
    rf_rows = (int(p["speed_of_sound"]) * window_us) // axial_um
    march_dt = axial_mm * 1000.0 / p["speed_of_sound"]

    draws = d * frames * elements * samples
    ciphers = frames * elements * samples + CIPHERS_PER_BOUNCE * draws
    costs = {"draws": (2 * 8 * frames + DRAW_FIELDS * 4 * draws,
                       ciphers * OPS_THREEFRY + DRAW_FIELDS * draws * OPS_UNIFORM
                       + draws * OPS_NORMAL)}

    node_bytes, tri_bytes = 6 * 4 + 2 * 4, 9 * 4 + 4
    w_b = w_o = 0
    for b in range(d):
        rays = segments["rays"][b].contiguous()
        counts, (seen_nodes, seen_tris) = walk(rays, tree)
        w_b += (nbytes(rays) + 8 * rays.shape[1] + int(seen_nodes.sum()) * node_bytes
                + int(seen_tris.sum()) * tri_bytes)
        w_o += int(counts[0].sum()) * OPS_SLAB_NODE + int(counts[1].sum()) * OPS_MOLLER_TRUMBORE
    valid = segments["valid"]
    costs["trace"] = (w_b + DRAW_FIELDS * 4 * valid.numel()
                      + nbytes(*(segments[k] for k in SEGMENT_FIELDS)),
                      w_o + int(valid.sum()) * OPS_BOUNCE)

    seg_len = torch.sqrt(_dot(segments["to"] - segments["from"],
                              segments["to"] - segments["from"])) * 10.0
    steps = torch.floor(seg_len / torch.tensor(axial_mm, device=seg_len.device))
    t0 = segments["distance"] * 1000.0 / torch.tensor(p["speed_of_sound"], device=seg_len.device)
    in_window = torch.ceil((float(window_us) - t0) / march_dt).clamp(min=0.0)
    matched = int((torch.minimum(steps, in_window) * valid).sum())
    n_cols = frames * elements
    c_pad = n_cols + (-n_cols) % TILE_C
    costs["march"] = (samples * d * SOA_FIELDS * c_pad * 4 + 4 * rf_rows * n_cols,
                      matched * OPS_MARCH_STEP)
    cells = frames * rf_rows * elements
    costs["postproc"] = (2 * 4 * cells, cells * OPS_POSTPROC_CELL)
    n_bm = p["bmode_rows"] * p["bmode_cols"]
    costs["scan_convert"] = (4 * frames * rf_rows * elements + 2 * 4 * n_bm + 4 * frames * n_bm,
                             frames * n_bm * OPS_SCANCONV_PIXEL)
    return costs


def frame_floor_ms(segments: dict, tree: Tree, p: dict) -> float:
    """The floor of one frame, ms: the stages' floors summed, over the frames."""
    costs = stage_costs(segments, tree, p)
    n = segments["valid"].shape[1]
    frames = n // (p["transducer_elements"] * p["samples_per_element"])
    return sum(floor_ms(b, o) for b, o in costs.values()) / frames
