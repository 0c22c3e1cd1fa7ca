"""The march forward in every texture mode and its backward (the formulas of
K2 and K8) on the CPU, against the reference's Pallas march op in interpret
mode and against autograd of the plain forward.

Inputs: the packed SoA of a seeded 16-element x 2-path sphere frame of the
port, and a cotangent from a numpy seed; both packages get the same arrays.

Tolerances. Forward: rtol 1e-4, atol 1e-5 (``exp``/``sigmoid`` differ by an
ulp between the frameworks), as ``tests/test_torch_march.py``. Backward: per
SoA field, max |port - reference| <= 1e-4 x max |reference|, 5e-4 in
trilinear mode (its position partials are differences of hashed corner
values, which cancel) — the reference's own kernel-vs-plain gradient test
allows 2e-4 and 2e-3 (``tests/test_grad_pallas.py:83``); the field sums run
over up to ~466 march steps in another order. Against autograd of ``march_plain`` the same
formulas are held to 1e-5 x max.

Borderline steps. A march step whose time lies within an ulp of an RF row
boundary is binned into one row by the reference's jitted kernel (XLA on the
CPU contracts ``t0 + k*dt`` into an FMA) and into the next by the port,
which rounds every operation as the reference does op by op (the same split
``tests/test_torch_slice.py`` documents for edge-grazing rays). Such steps
are found in float64 (``_borderline``: row quotient within 5e-5 of an
integer), and the RF cells and (segment, column) gradient entries they touch
are left out of the comparison with the reference; they must stay under 1%
of the cells and 5% of the entries.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import SPHERE_SCENE, both_configs, to_np
from mcray_tpu.ops.pallas import march as ref_march
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.ops.cuda import march
from mcray_tpu_torch.scene.compile import load_and_compile

MODES = {
    "hard_nearest": {},
    "soft_nearest": {"soft_scattering": True},
    "hard_trilinear": {"trilinear_texture": True},
    "soft_trilinear": {"soft_scattering": True, "trilinear_texture": True},
}
ZERO_FIELDS = (march.F_T0, march.F_STEPS, march.F_B_ROW, march.F_VALID)


@pytest.fixture(scope="module")
def frame():
    """(soa, seeds, cotangent) of a seeded port frame (the SoA does not
    depend on the texture mode)."""
    _, cfg = both_configs(transducer_elements=16, samples_per_element=2)
    sim = Simulator(load_and_compile(SPHERE_SCENE), cfg, device="cpu", seed=3)
    soa = sim.render_frame(4)["soa"]
    g = np.random.default_rng(11).standard_normal((cfg.rf_rows, cfg.rf_cols)).astype(np.float32)
    assert soa.shape == (2 * cfg.max_depth, march.N_FIELDS, 128)
    return soa, sim.seeds, torch.from_numpy(g)


def _reference(ref_cfg, soa, seeds, g):
    """The reference op's padded RF image and its VJP for ``g``."""
    op = ref_march._march_op(ref_cfg, True)
    seeds_j = jnp.asarray(to_np(seeds), jnp.int32).reshape(1, 2)
    rf, vjp = jax.vjp(lambda s: op(s, seeds_j), jnp.asarray(to_np(soa)))
    g_pad = np.zeros(rf.shape, np.float32)
    g_pad[: g.shape[0], : g.shape[1]] = to_np(g)
    return np.asarray(rf), np.asarray(vjp(jnp.asarray(g_pad))[0])


def _field_errors(got, want, keep=None):
    """Per field: (max abs err, max |want|), over the (segment, column)
    entries of ``keep`` (all by default)."""
    keep = np.ones(got[:, 0].shape, bool) if keep is None else keep
    return [(float(np.abs(got[:, f] - want[:, f])[keep].max()),
             float(np.abs(want[:, f])[keep].max())) for f in range(march.N_FIELDS)]


def _borderline(soa, cfg):
    """(cells (rf_rows, C) bool, entries (SD, C) bool) touched by a march step
    or boundary echo whose row quotient t / rdt lies within 5e-5 of an integer."""
    s = to_np(soa).astype(np.float64)
    k = np.arange(cfg.max_march_steps + 1, dtype=np.float64)[None, :, None]
    t0, steps = s[:, None, march.F_T0], s[:, None, march.F_STEPS]
    q = (t0 + k * cfg.march_dt_us) / cfg.rf_row_dt_us            # (SD, K, C)
    live = (k < steps) & (s[:, None, march.F_VALID] > 0.5) & (q < cfg.rf_rows + 1)
    near = live & (q > 0) & (np.abs(q - np.round(q)) < 5e-5)  # t = 0 is exact
    cells = np.zeros((cfg.rf_rows + 2, s.shape[2]), bool)
    seg, step, col = np.nonzero(near)
    for shift in (-1, 0):
        row = np.clip(np.round(q[seg, step, col]).astype(int) + shift, 0, cfg.rf_rows + 1)
        cells[row, col] = True
    return cells[: cfg.rf_rows], near.any(axis=1)


@pytest.mark.parametrize("mode", MODES)
def test_march_forward_and_backward_match_reference(frame, mode):
    soa, seeds, g = frame
    ref_cfg, cfg = both_configs(transducer_elements=16, samples_per_element=2, **MODES[mode])
    want_rf, want_grad = _reference(ref_cfg, soa, seeds, g)

    x = soa.clone().requires_grad_(True)
    rf = march.march_cuda(x, seeds, cfg, cfg.rf_cols)  # CPU tensor: the plain versions
    (grad,) = torch.autograd.grad(rf, x, g)
    edge_cells, edge_entries = _borderline(soa, cfg)
    assert edge_cells.mean() < 0.01 and edge_entries[:, : cfg.rf_cols].mean() < 0.05
    keep = ~edge_cells[:, : cfg.rf_cols]
    np.testing.assert_allclose(to_np(rf)[keep], want_rf[: cfg.rf_rows, : cfg.rf_cols][keep],
                               rtol=1e-4, atol=1e-5)
    assert np.abs(want_rf).max() > 0.1
    errors = _field_errors(to_np(grad), want_grad, ~edge_entries)
    tol = 5e-4 if "trilinear" in mode else 1e-4
    for f, (err, scale) in enumerate(errors):
        assert err <= tol * scale, f"field {f}: err {err}, max |reference| {scale}"
        assert (scale == 0.0) == (f in ZERO_FIELDS or (
            "trilinear" not in mode and f < 6) or ("soft" not in mode and f == march.F_MU1)), f


@pytest.mark.parametrize("mode", MODES)
def test_march_backward_matches_autograd_of_plain(frame, mode):
    soa, seeds, g = frame
    _, cfg = both_configs(transducer_elements=16, samples_per_element=2, **MODES[mode])
    x = soa.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(march.march_plain(x, seeds, cfg, cfg.rf_cols), x, g)
    got = march.march_bwd_plain(soa, seeds, g, cfg)
    for f, (err, scale) in enumerate(_field_errors(to_np(got), to_np(want))):
        assert err <= 1e-5 * scale, f"field {f}: err {err}, max |autograd| {scale}"


def test_segment_walk_matches_the_forward_row_match(frame):
    """K8 walks each segment's own steps and bins them forward; the set of
    (segment, column, row) it visits, and the step it visits each with, must
    equal what the forward's ``_match_rows`` finds per row, bitwise."""
    soa, _, _ = frame
    _, cfg = both_configs(transducer_elements=16, samples_per_element=2)
    rdt = torch.tensor(cfg.rf_row_dt_us, dtype=torch.float32)
    rows_f = torch.arange(cfg.rf_rows, dtype=torch.float32)[:, None]
    k = torch.arange(cfg.max_march_steps + 4, dtype=torch.float32)[:, None]
    n_matched = 0
    for f in soa:
        t0, steps, valid = f[march.F_T0], f[march.F_STEPS], f[march.F_VALID] > 0.5
        matched, k_sel = march._match_rows(rows_f, t0, steps, valid, cfg)
        # the walk: k = 0, 1, ... while k < steps and t_k < window, row = floor(t_k / rdt)
        t_k = t0 + k * cfg.march_dt_us
        row = torch.floor(t_k / rdt)
        live = (k < steps) & (t_k < float(cfg.max_travel_time_us)) & valid \
            & (row >= 0) & (row < cfg.rf_rows)
        walked = torch.zeros_like(matched)
        walked_k = torch.zeros_like(k_sel)
        cols = torch.arange(f.shape[1])[None, :].expand_as(row)
        index = (row[live].long(), cols[live])
        walked[index] = True
        walked_k[index] = k.expand_as(row)[live]
        assert int(live.sum()) == int(walked.sum())  # no two steps of a segment share a row
        assert torch.equal(walked, matched)
        assert torch.equal(torch.where(matched, k_sel, 0.0), walked_k)
        n_matched += int(matched.sum())
    assert n_matched > 1000


@pytest.mark.parametrize("overrides", [
    {"scatter_rng": "boxmuller"},
    {"volume_size": 48},
    {"soft_scattering": True, "trilinear_texture": True},
    {"texture_mode": "table"},
    {"scatter_rng": "boxmuller", "volume_size": 48, "trilinear_texture": True,
     "soft_scattering": True},
], ids=["boxmuller", "volume-48", "fit-modes", "table", "all-at-once"])
def test_kernel_modes_pass_the_argument_checks(frame, monkeypatch, overrides):
    """Every mode of the reference's kernel is a mode of K2 and K8: the
    wrappers' checks take it (here with the device check stubbed, as there
    is no card) and pass its flags to the C entries."""
    soa, seeds, _ = frame
    _, cfg = both_configs(**overrides)
    monkeypatch.setattr(march._build, "require", lambda *args, **kw: None)
    sd, c_pad, seed0, seed1 = march._kernel_args(soa, seeds, cfg, cfg.rf_cols)
    assert (sd, c_pad) == (soa.shape[0], soa.shape[2])
    assert [seed0, seed1] == [int(v) & 0xFFFFFFFF for v in seeds.tolist()]
    _, size, _, trilinear, soft, boxmuller, _ = march._texture_args(cfg)
    assert (size, trilinear, soft, boxmuller) == (
        cfg.volume_size, int(cfg.trilinear_texture), int(cfg.soft_scattering),
        int(cfg.scatter_rng == "boxmuller"))
