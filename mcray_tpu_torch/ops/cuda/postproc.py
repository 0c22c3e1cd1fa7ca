"""K3: PSF convolution fused with the envelope (``csrc/postproc.cu``).

Replaces ``mcray_tpu/ops/pallas/postproc.py:_postproc_kernel`` (op
``_postproc_op``, wrapper ``convolve_envelope_pallas``): the reference's
uncentered separable convolution (7 axial x 13 lateral taps; cells outside
the write window keep their raw values, ``imaging._convolve_reference``)
followed by the closed-form peak-lerp envelope (``imaging.envelope``).

On the card: one block per 32 columns. Its threads first compute the
convolution of their columns' cells in parallel (taps summed k = 0..A-1,
then 0..L-1, as the reference sums them) into the output; then one thread
per column walks the rows in order and rewrites them with the envelope —
the reference C++ walk, whose state (last peak) needs no scan at all. The
convolution runs on every thread of the block; the kernel is bound by the
serial row walk (465 dependent steps per column at full size, on one
thread of 8).

Modes: reference envelope with uncentered PSF only; the centered PSF and
the Hilbert envelope raise NotImplementedError for CUDA tensors.

Backward: ``postproc_cuda`` is a ``torch.autograd.Function`` whose backward
is the VJP of ``postproc_plain`` recomputed on the saved input — what the
reference does (``postproc.py:_postproc_op``: ``jax.vjp`` of the plain
convolution + envelope, outside any Pallas kernel). So on the card this
backward is plain PyTorch (autograd over ``postproc_plain``); it replaces no
kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...config import SimConfig
from .. import imaging
from .. import psf as psf_mod
from . import _build

#: kernel launches since the last reset (one per call on a CUDA tensor)
launches = 0


def postproc_plain(rf: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Plain version: ``imaging.apply_envelope(imaging.convolve_psf(rf))``."""
    return imaging.apply_envelope(imaging.convolve_psf(rf, cfg), cfg)


@functools.lru_cache(maxsize=8)
def _taps(cfg: SimConfig, device: torch.device) -> torch.Tensor:
    """The axial then the lateral taps, one small tensor on ``device``."""
    taps = np.concatenate([psf_mod.axial_kernel_np(cfg), psf_mod.lateral_kernel_np(cfg)])
    return torch.from_numpy(taps).to(device)


def postproc_bwd_plain(rf: torch.Tensor, g: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """The gradient of ``postproc_plain`` at ``rf`` for the cotangent ``g``,
    by autograd over the plain version (rematerialised: nothing is saved
    from the forward but ``rf``)."""
    with torch.enable_grad():
        x = rf.detach().requires_grad_(True)
        y = postproc_plain(x, cfg)
    return torch.autograd.grad(y, x, g)[0]


class _Postproc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rf, cfg):
        ctx.save_for_backward(rf)
        ctx.cfg = cfg
        return postproc_forward(rf, cfg)

    @staticmethod
    def backward(ctx, g):
        (rf,) = ctx.saved_tensors
        return postproc_bwd_plain(rf, g, ctx.cfg), None


def postproc_cuda(rf: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Convolved + enveloped RF image of the same (rows, cols) shape,
    differentiable in ``rf``: the CUDA kernel for a CUDA ``rf``, the plain
    version for a CPU one; the backward is ``postproc_bwd_plain`` on both."""
    return _Postproc.apply(rf, cfg)


def postproc_forward(rf: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """K3 for a CUDA ``rf``, ``postproc_plain`` for a CPU one (no autograd)."""
    global launches
    if rf.device.type == "cpu":
        return postproc_plain(rf, cfg)
    rows, cols = rf.shape
    _build.require(rf, "rf", torch.float32, (rows, cols))
    if cfg.centered_psf or cfg.envelope_mode != "reference":
        raise NotImplementedError(
            "the CUDA postproc kernel computes the uncentered PSF and the "
            "reference envelope only"
        )
    a, l = cfg.psf_axial_size, cfg.psf_lateral_size
    taps = _taps(cfg, rf.device)
    do_conv = int(rows > 2 * a and cols > l + l // 2)  # else the reference's loops never run
    out = torch.empty_like(rf)
    code = _build.library().mcray_postproc(
        rf.data_ptr(), rows, cols, taps.data_ptr(), a, taps[a:].data_ptr(), l, do_conv,
        out.data_ptr(), _build.stream_of(rf),
    )
    _build.check(code, "mcray_postproc")
    launches += 1
    return out
