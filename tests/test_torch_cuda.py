"""The four CUDA kernels against their plain versions, on an NVIDIA GPU.

These tests need the card and the CUDA toolkit (the kernels are built with
nvcc at first use); without a GPU they skip. They import no JAX, so they
also run where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerances are those of chip_smoke.py: the closest hit bitwise (FMA
contraction is off in the kernels, and plain PyTorch on CUDA rounds every
op), the march at rtol 1e-4 / atol 1e-5, the postproc at 1e-5 / 1e-6 and
the scan conversion at 1e-6 / 1e-6.
"""

import numpy as np
import pytest
import torch

from _torch_port import SPHERE_SCENE, random_segments, random_triangles, to_torch
from mcray_tpu_torch.config import SimConfig, small_test_config
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.ops import geometry, imaging
from mcray_tpu_torch.ops.cuda import intersect, march, postproc, scanconv
from mcray_tpu_torch.scene.compile import load_and_compile

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
        scanconv.scan_convert_cuda(out["rf_env"], sim.scan_table, cfg.bmode_cols).cpu(),
        scanconv.scan_convert_plain(out["rf_env"], sim.scan_table, cfg.bmode_cols).cpu(),
        rtol=1e-6, atol=1e-6)


def test_wrappers_reject_bad_inputs(cuda):
    cfg = SimConfig()
    rf = torch.zeros((cfg.rf_rows, cfg.rf_cols), device=cuda)
    with pytest.raises(TypeError):
        postproc.postproc_cuda(rf.double(), cfg)
    with pytest.raises(ValueError):
        postproc.postproc_cuda(rf.T, cfg)  # not contiguous
    table = torch.from_numpy(scanconv.pack_scan_maps(
        *imaging.scan_conversion_maps(cfg), cfg.rf_rows, cfg.rf_cols))
    with pytest.raises(ValueError):
        scanconv.scan_convert_cuda(rf, table, cfg.bmode_cols)  # table left on the CPU
    soa = torch.zeros((4, march.N_FIELDS, 128), device=cuda)
    with pytest.raises(NotImplementedError):
        march.march_cuda(soa, torch.zeros(2, dtype=torch.int64),
                         SimConfig(scatter_rng="boxmuller"), 128)
