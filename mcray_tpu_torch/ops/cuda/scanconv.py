"""K4: bilinear polar -> Cartesian scan conversion (``csrc/scanconv.cu``).

Replaces both ``mcray_tpu/ops/pallas/scanconv.py:_scanconv_kernel`` and
``_scanconv_banded_kernel`` (op ``_scanconv_banded_op``, wrapper
``scan_convert_banded``): cv::remap with INTER_LINEAR and BORDER_CONSTANT.
The TPU computes the remap as one-hot MXU matmuls because its gathers are
slow; on the card it is what it is, a gather: one thread per B-mode pixel
reads its six-entry row of the packed table (``pack_scan_maps``) and sums
the four taps in f32, in ``map_coordinates``' order. The TPU's bf16 MXU
rounding is not reproduced; the contract is ``imaging.scan_convert``.

Bound: the latency of 4 independent gathers per pixel; the (out_rows, 8,
W_pad) table and the RF image are small enough to stay in L2.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import imaging
from . import _build

LANES = 128

#: kernel launches since the last reset (one per call on a CUDA tensor)
launches = 0


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
    """Plain version: the same 4-tap gather from the packed table."""
    t = table[:, :, :out_cols]
    return imaging.bilinear_gather(rf, t[:, 0].long(), t[:, 1], t[:, 2], t[:, 3].long(), t[:, 4], t[:, 5])


def scan_convert_cuda(rf: torch.Tensor, table: torch.Tensor, out_cols: int) -> torch.Tensor:
    """B-mode image (out_rows, out_cols) from the enveloped RF image: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    global launches
    if rf.device.type == "cpu" and table.device.type == "cpu":
        return scan_convert_plain(rf, table, out_cols)
    rows, cols = rf.shape
    out_rows, _, w_pad = table.shape
    _build.require(rf, "rf", torch.float32, (rows, cols))
    _build.require(table, "table", torch.float32, (out_rows, 8, w_pad))
    if not out_cols <= w_pad:
        raise ValueError(f"out_cols={out_cols} exceeds the table width {w_pad}")
    out = torch.empty((out_rows, out_cols), dtype=torch.float32, device=rf.device)
    code = _build.library().mcray_scan_convert(
        rf.data_ptr(), rows, cols, table.data_ptr(), out_rows, out_cols, w_pad,
        out.data_ptr(), _build.stream_of(rf),
    )
    _build.check(code, "mcray_scan_convert")
    launches += 1
    return out
