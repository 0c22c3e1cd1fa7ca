"""K4 and K9: bilinear polar -> Cartesian scan conversion and its backward
(``csrc/scanconv.cu``, ``csrc/scanconv_bwd.cu``).

Replaces both ``mcray_tpu/ops/pallas/scanconv.py:_scanconv_kernel`` and
``_scanconv_banded_kernel`` (op ``_scanconv_banded_op``, wrapper
``scan_convert_banded``): cv::remap with INTER_LINEAR and BORDER_CONSTANT.
The TPU computes the remap as one-hot MXU matmuls because its gathers are
slow; on the card it is what it is, a gather. K4 reads only the RF image
and the two f32 coordinate maps (``ScanMaps.coords``), 8 bytes per pixel,
which is what its bound counts: a thread per pixel computes the pixel's
floor, fraction and edge weights as ``pack_scan_maps`` does on the host, in
the same f32 operations, and sums the four taps in ``map_coordinates``'
order. So K4 equals the
table-driven ``scan_convert_plain`` bit for bit; ``scan_convert_coords_plain``
is the same computation from the maps in plain torch, and what the card's
tests hold K4 to. A pixel outside the fan (all four weights 0) writes 0 and
reads no RF value. The TPU's bf16 MXU rounding is not reproduced; the
contract is ``imaging.scan_convert``.

Bound: bytes (the image, the maps and the output, ~3.35 MB at SimConfig);
the RF image stays in L2.

K9 replaces ``_scanconv_bwd_kernel`` and ``_scanconv_banded_bwd_kernel``
(one kernel for both, as K4: the banded/full split only shortens the TPU's
matrix contraction): the transposed remap, B-mode cotangent (out_rows,
out_cols) -> RF gradient (rows, cols). The maps are static, so the
transposition is done once on the host (``invert_scan_table``): for each RF
cell the list of (output pixel, weight) that read it, in CSR form with
ascending pixels. One thread per RF cell then sums ``w * g[pixel]`` over its
list — a gather again: no atomics, one summation order. Zero-weight and
out-of-range taps are left out (BORDER_CONSTANT). The kernel reads the CSR
lists once, about three times the bytes the function itself needs (the
cotangent, the two coordinate maps, the gradient). ``scan_convert_bwd_plain``
is the four transposed taps as ``index_put_(accumulate=True)``.

The maps, the table and its transpose are one static object, ``ScanMaps``,
built together by ``scan_maps``. ``scan_convert_cuda`` is a
``torch.autograd.Function`` over both kernels: K4 / K9 for CUDA tensors, the
plain versions for CPU tensors.

Frames: every function here takes one image, (rows, cols) -> (out_rows,
out_cols), or a batch of frames, (F, rows, cols) -> (F, out_rows,
out_cols), on the same maps. A batch is one launch of K4 (and of K9): the
grid's second axis is the frame.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import imaging
from . import _build

LANES = 128


def pack_scan_maps(map_row: np.ndarray, map_col: np.ndarray, rf_rows: int, rf_cols: int):
    """Host-side per-pixel interpolation table (out_rows, 8, W_pad): rows
    [r0, w_r0, w_r1, c0, w_c0, w_c1, 0, 0] along dim 1, output column along
    dim 2 (copy of the reference's ``pack_scan_maps``). Out-of-range taps get
    zero axis weight (BORDER_CONSTANT)."""
    map_row = np.asarray(map_row, np.float32)
    map_col = np.asarray(map_col, np.float32)
    out_rows, out_cols = map_row.shape
    r0 = np.floor(map_row)
    c0 = np.floor(map_col)
    ar = map_row - r0
    ac = map_col - c0

    def axis_w(i0, frac, n):
        w0 = (1.0 - frac) * ((i0 >= 0) & (i0 <= n - 1))
        w1 = frac * ((i0 + 1 >= 0) & (i0 + 1 <= n - 1))
        return w0.astype(np.float32), w1.astype(np.float32)

    w_r0, w_r1 = axis_w(r0, ar, rf_rows)
    w_c0, w_c1 = axis_w(c0, ac, rf_cols)
    w_pad = ((out_cols + LANES - 1) // LANES) * LANES
    table = np.zeros((out_rows, 8, w_pad), np.float32)
    table[:, 0, :out_cols] = np.clip(r0, -1, rf_rows - 1)
    table[:, 1, :out_cols] = w_r0
    table[:, 2, :out_cols] = w_r1
    table[:, 3, :out_cols] = np.clip(c0, -1, rf_cols - 1)
    table[:, 4, :out_cols] = w_c0
    table[:, 5, :out_cols] = w_c1
    return table


def scan_convert_plain(rf: torch.Tensor, table: torch.Tensor, out_cols: int) -> torch.Tensor:
    """Plain version: the same 4-tap gather from the packed table, per
    image of ``rf`` (rows, cols) or (frames, rows, cols)."""
    t = table[:, :, :out_cols]
    return imaging.bilinear_gather(rf, t[:, 0].long(), t[:, 1], t[:, 2], t[:, 3].long(), t[:, 4], t[:, 5])


def scan_convert_coords_plain(rf: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Plain version of K4 as the kernel computes it: from the (2, out_rows,
    out_cols) coordinate maps, each pixel's floor, fraction and edge weights
    in ``pack_scan_maps``' f32 operations, the four taps, and 0 where all
    four weights are 0. Equal to ``scan_convert_plain`` on the packed table
    (a pixel outside the fan is +0.0 here, a sum of zero-weighted taps there).
    ``rf`` may carry a leading frame axis."""
    rows, cols = rf.shape[-2:]

    def axis(m, n):
        i0 = torch.floor(m)
        frac = m - i0
        w0 = (1.0 - frac) * ((i0 >= 0) & (i0 <= n - 1)).to(m.dtype)
        w1 = frac * ((i0 + 1 >= 0) & (i0 + 1 <= n - 1)).to(m.dtype)
        return torch.clamp(i0, -1, n - 1).long(), w0, w1

    r0, w_r0, w_r1 = axis(coords[0], rows)
    c0, w_c0, w_c1 = axis(coords[1], cols)
    out = imaging.bilinear_gather(rf, r0, w_r0, w_r1, c0, w_c0, w_c1)
    outside = ((w_r0 * w_c0 == 0) & (w_r0 * w_c1 == 0) & (w_r1 * w_c0 == 0)
               & (w_r1 * w_c1 == 0))
    return torch.where(outside, 0.0, out)


def invert_scan_table(table: np.ndarray, rf_rows: int, rf_cols: int, out_cols: int):
    """The transposed remap of a packed table (host side): per RF cell the
    output pixels that read it and their weights, as CSR arrays ``row_ptr``
    (rf_rows * rf_cols + 1,) i32, ``pixel`` (nnz,) i32 (flat index into the
    (out_rows, out_cols) image, ascending within a cell) and ``weight``
    (nnz,) f32 — the products ``w_r * w_c`` the forward multiplies each tap
    by. Taps with zero weight or outside the RF image are left out."""
    t = np.asarray(table, np.float32)[:, :, :out_cols]
    out_rows = t.shape[0]
    r0, c0 = t[:, 0].astype(np.int64), t[:, 3].astype(np.int64)
    pixel = np.arange(out_rows * out_cols, dtype=np.int64).reshape(out_rows, out_cols)
    cells, pixels, weights = [], [], []
    for dr, w_r in ((0, t[:, 1]), (1, t[:, 2])):
        for dc, w_c in ((0, t[:, 4]), (1, t[:, 5])):
            r, c, w = r0 + dr, c0 + dc, w_r * w_c
            ok = (r >= 0) & (r < rf_rows) & (c >= 0) & (c < rf_cols) & (w != 0.0)
            cells.append((r * rf_cols + c)[ok])
            pixels.append(pixel[ok])
            weights.append(w[ok])
    cells, pixels, weights = (np.concatenate(x) for x in (cells, pixels, weights))
    order = np.lexsort((pixels, cells))
    row_ptr = np.zeros(rf_rows * rf_cols + 1, np.int64)
    np.cumsum(np.bincount(cells, minlength=rf_rows * rf_cols), out=row_ptr[1:])
    return (row_ptr.astype(np.int32), pixels[order].astype(np.int32),
            weights[order].astype(np.float32))


def scan_convert_bwd_plain(g: torch.Tensor, table: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Plain version of the backward: the RF gradient (rows, cols) from the
    B-mode cotangent ``g`` (out_rows, out_cols), the four taps transposed
    into scatter-adds; a cotangent (F, out_rows, out_cols) gives (F, rows,
    cols), each frame's taps into its own image."""
    lead = g.shape[:-2]
    g = g.reshape((-1,) + g.shape[-2:])
    t = table[:, :, : g.shape[-1]]
    r0, c0 = t[:, 0].long(), t[:, 3].long()
    base = torch.arange(g.shape[0], device=g.device)[:, None, None] * (rows * cols)
    grf = torch.zeros(g.shape[0] * rows * cols, dtype=g.dtype, device=g.device)
    for dr, w_r in ((0, t[:, 1]), (1, t[:, 2])):
        for dc, w_c in ((0, t[:, 4]), (1, t[:, 5])):
            r, c = r0 + dr, c0 + dc
            ok = (r >= 0) & (r < rows) & (c >= 0) & (c < cols)
            index = base + (r.clamp(0, rows - 1) * cols + c.clamp(0, cols - 1))
            grf.index_put_((index.reshape(-1),),
                           torch.where(ok, (w_r * w_c) * g, 0.0).reshape(-1), accumulate=True)
    return grf.reshape(lead + (rows, cols))


@dataclasses.dataclass(frozen=True)
class ScanMaps:
    """The static remap of one probe geometry on one device: the coordinate
    maps ``coords`` that K4 reads, the packed per-pixel ``table``
    (``pack_scan_maps``) that the plain versions read, and its transpose
    (``invert_scan_table``: ``row_ptr``, ``pixel``, ``weight``) that K9 reads,
    built together by ``scan_maps``."""

    coords: torch.Tensor   # (2, out_rows, out_cols) f32: map_row, map_col
    table: torch.Tensor    # (out_rows, 8, W_pad) f32
    row_ptr: torch.Tensor  # (rf_rows * rf_cols + 1,) i32
    pixel: torch.Tensor    # (nnz,) i32
    weight: torch.Tensor   # (nnz,) f32
    rf_rows: int
    rf_cols: int
    out_cols: int


def scan_maps(map_row: np.ndarray, map_col: np.ndarray, rf_rows: int, rf_cols: int,
              device="cpu") -> ScanMaps:
    """``ScanMaps`` on ``device`` from the (out_rows, out_cols) coordinate
    maps of ``imaging.scan_conversion_maps`` (host side, once per geometry)."""
    out_cols = np.shape(map_row)[1]
    coords = np.stack([np.asarray(map_row, np.float32), np.asarray(map_col, np.float32)])
    table = pack_scan_maps(map_row, map_col, rf_rows, rf_cols)
    inverse = invert_scan_table(table, rf_rows, rf_cols, out_cols)
    return ScanMaps(*(torch.from_numpy(a).to(device) for a in (coords, table, *inverse)),
                    rf_rows, rf_cols, out_cols)


def _frames(x: torch.Tensor, name: str, image: tuple) -> tuple[tuple, int]:
    """(the leading shape, the frame count) of ``x``, one ``image``-shaped
    image or a (frames, *image) batch of them; else ValueError."""
    lead = tuple(x.shape[:-2])
    if len(lead) > 1 or tuple(x.shape[-2:]) != tuple(image):
        raise ValueError(f"{name}: expected {tuple(image)} or (frames, *{tuple(image)}), got "
                         f"{tuple(x.shape)}")
    return lead, lead[0] if lead else 1


def scan_convert_backward(g: torch.Tensor, maps: ScanMaps) -> torch.Tensor:
    """RF gradient (rf_rows, rf_cols) from the B-mode cotangent ``g``
    (out_rows, out_cols), or (F, rf_rows, rf_cols) from (F, out_rows,
    out_cols): K9 for CUDA tensors, ``scan_convert_bwd_plain`` for CPU tensors."""
    rows, cols = maps.rf_rows, maps.rf_cols
    if g.device.type == "cpu" and maps.table.device.type == "cpu":
        return scan_convert_bwd_plain(g, maps.table, rows, cols)
    n_cells = rows * cols
    lead, frames = _frames(g, "g", (maps.table.shape[0], maps.out_cols))
    _build.require(g, "g", torch.float32)
    _build.require(maps.row_ptr, "row_ptr", torch.int32, (n_cells + 1,))
    _build.require(maps.pixel, "pixel", torch.int32)
    _build.require(maps.weight, "weight", torch.float32, tuple(maps.pixel.shape))
    out = torch.empty(lead + (rows, cols), dtype=torch.float32, device=g.device)
    _build.launch(
        "mcray_scan_convert_bwd",
        maps.row_ptr.data_ptr(), maps.pixel.data_ptr(), maps.weight.data_ptr(), g.data_ptr(),
        n_cells, g.shape[-2] * g.shape[-1], frames, out.data_ptr(), device=g.device,
    )
    return out


class _ScanConvert(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rf, maps):
        ctx.maps = maps
        return scan_convert_forward(rf, maps)

    @staticmethod
    def backward(ctx, g):
        return scan_convert_backward(g.contiguous(), ctx.maps), None


def scan_convert_cuda(rf: torch.Tensor, maps: ScanMaps) -> torch.Tensor:
    """B-mode image (out_rows, out_cols) from the enveloped RF image (or
    (F, out_rows, out_cols) from F of them),
    differentiable in ``rf``: the CUDA kernels (K4 forward, K9 backward) for
    CUDA tensors, the plain versions for CPU tensors."""
    return _ScanConvert.apply(rf, maps)


def scan_convert_forward(rf: torch.Tensor, maps: ScanMaps) -> torch.Tensor:
    """K4 for CUDA tensors, ``scan_convert_plain`` for CPU tensors (no
    autograd); ``rf`` is (rf_rows, rf_cols) or (F, rf_rows, rf_cols)."""
    if rf.device.type == "cpu" and maps.table.device.type == "cpu":
        return scan_convert_plain(rf, maps.table, maps.out_cols)
    rows, cols = maps.rf_rows, maps.rf_cols
    out_rows = maps.table.shape[0]
    lead, frames = _frames(rf, "rf", (rows, cols))
    _build.require(rf, "rf", torch.float32)
    _build.require(maps.coords, "coords", torch.float32, (2, out_rows, maps.out_cols))
    out = torch.empty(lead + (out_rows, maps.out_cols), dtype=torch.float32, device=rf.device)
    _build.launch(
        "mcray_scan_convert",
        rf.data_ptr(), rows, cols, frames, maps.coords.data_ptr(), out_rows * maps.out_cols,
        out.data_ptr(), device=rf.device,
    )
    return out
