"""K3: PSF convolution fused with the envelope (``csrc/postproc.cu``).

Replaces ``mcray_tpu/ops/pallas/postproc.py:_postproc_kernel`` (op
``_postproc_op``, wrapper ``convolve_envelope_pallas``): the reference's
uncentered separable convolution (7 axial x 13 lateral taps; cells outside
the write window keep their raw values, ``imaging._convolve_reference``)
followed by the closed-form peak-lerp envelope (``imaging.envelope``).

On the card the kernel is bound by bytes (the image read once and written
once, 0.6 us at 465 x 512), so its time is latency: a block owns a strip
of 4 whole columns in shared memory (loaded once with the lateral
halo), sums the taps separably (A + L products per cell, in the reference's
order of additions), and computes the envelope as two warp scans per
column — the previous peak of a row is a running maximum, the next peak a
reverse running minimum, as in ``imaging.envelope`` — after which every row
lerps on its own. The convolved image never goes to device memory; the
source's header note has the details. Images of any height: past 992 rows
(31 rows per lane's peak mask) a second instance walks longer runs, and
where a strip's buffers outgrow a block's shared memory (~1,600 rows) they
go to a slab of device memory the wrapper allocates. A batch of frames
(F, rows, cols) is one launch: the grid's second axis is the frame, and
every frame's window and lateral halo are its own.

Modes: the kernel computes the reference envelope after the uncentered
PSF. The centered PSF and the Hilbert envelope are no mode of the
reference's kernel either: it leaves its kernel for jnp there
(``mcray_tpu/models/simulator.py:390-397``), and ``postproc_forward`` runs
``postproc_plain`` (plain PyTorch, ``torch.fft`` for the Hilbert
transform) on the tensor's own device for them, launching nothing.

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


#: shared memory a block may use on sm_90 (227 KB); taller strips use a slab
#: of device memory instead
MAX_SHARED_BYTES = 232448


def postproc_plain(rf: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Plain version: ``imaging.apply_envelope(imaging.convolve_psf(rf))``,
    per image of (rows, cols) or (frames, rows, cols)."""
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
    """Convolved + enveloped RF image(s) of the same (rows, cols) or
    (frames, rows, cols) shape,
    differentiable in ``rf``: the CUDA kernel for a CUDA ``rf``, the plain
    version for a CPU one; the backward is ``postproc_bwd_plain`` on both."""
    return _Postproc.apply(rf, cfg)


def kernel_modes(cfg: SimConfig) -> bool:
    """Whether K3 computes ``cfg``'s postproc: the uncentered PSF and the
    reference envelope, the modes of the reference's fused kernel."""
    return not cfg.centered_psf and cfg.envelope_mode == "reference"


def postproc_forward(rf: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """K3 for a CUDA ``rf``, ``postproc_plain`` for a CPU one or for the
    modes K3 does not compute (no autograd)."""
    if rf.device.type == "cpu" or not kernel_modes(cfg):
        return postproc_plain(rf, cfg)
    if rf.dim() not in (2, 3):
        raise ValueError(f"rf: expected (rows, cols) or (frames, rows, cols), got {tuple(rf.shape)}")
    rows, cols = rf.shape[-2:]
    frames = rf.shape[0] if rf.dim() == 3 else 1
    _build.require(rf, "rf", torch.float32)
    a, l = cfg.psf_axial_size, cfg.psf_lateral_size
    taps = _taps(cfg, rf.device)
    do_conv = int(rows > 2 * a and cols > l + l // 2)  # else the reference's loops never run
    out = torch.empty_like(rf)
    lib = _build.library()
    n_slab = lib.mcray_postproc_slab_floats(rows, cols, frames, l, MAX_SHARED_BYTES)
    slab = torch.empty(n_slab, dtype=torch.float32, device=rf.device) if n_slab else None
    _build.launch(
        "mcray_postproc",
        rf.data_ptr(), rows, cols, frames, taps.data_ptr(), a, taps.data_ptr() + 4 * a, l,
        do_conv, slab.data_ptr() if slab is not None else None, out.data_ptr(), device=rf.device,
    )
    return out
