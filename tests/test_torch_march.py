"""K2's packing and plain version against the reference's Pallas march kernel.

The reference traces the sphere; its segments go to both packages.
``pack_segments`` must give the reference's (SD, 16, C_pad) SoA field by
field (integer-valued fields equal, floats at rtol 1e-6). The plain march
and the port's scatter march (``simulator.march_and_accumulate``) are held
against ``march_and_accumulate_pallas(..., interpret=True)`` and the
reference's scatter march at rtol 1e-4, atol 1e-5, the tolerance of
tests/test_pallas_march.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import SPHERE_SCENE, both_configs, to_np, to_torch
from mcray_tpu.models import simulator as ref_sim
from mcray_tpu.ops import texture as ref_texture
from mcray_tpu.ops.pallas import march as ref_march
from mcray_tpu.scene.compile import load_and_compile
from mcray_tpu_torch.models import simulator
from mcray_tpu_torch.ops.cuda import march

INT_FIELDS = (march.F_STEPS, march.F_B_ROW, march.F_VALID)


@pytest.fixture(scope="module")
def traced():
    ref_cfg, cfg = both_configs(transducer_elements=32, samples_per_element=2)
    pack = load_and_compile(SPHERE_SCENE, ref_cfg, with_bvh=False)
    mats = jnp.asarray(pack.materials)
    segs = ref_sim.trace_paths(
        jax.random.PRNGKey(0), mats,
        jnp.asarray(pack.transducer_position), jnp.asarray(pack.transducer_angles),
        {k: jnp.asarray(v) for k, v in pack.trace_tables().items()},
        jnp.asarray(pack.spacing), jnp.int32(pack.starting_material), ref_cfg,
    )
    vol = ref_texture.make_texture_volume(jax.random.PRNGKey(1), ref_cfg)
    port_segs = {k: to_torch(v) for k, v in segs.items()}
    return (ref_cfg, cfg), mats, segs, vol, port_segs, to_torch(pack.materials)


def test_pack_segments_matches(traced):
    (ref_cfg, cfg), mats, segs, _, port_segs, port_mats = traced
    want = np.asarray(ref_march.pack_segments(segs, mats, ref_cfg, ref_cfg.rf_cols))
    got = to_np(march.pack_segments(port_segs, port_mats, cfg, cfg.rf_cols))
    assert got.shape == want.shape == (2 * cfg.max_depth, march.N_FIELDS, 128)
    for f in range(march.N_FIELDS):
        if f in INT_FIELDS:
            np.testing.assert_array_equal(got[:, f], want[:, f], err_msg=f"field {f}")
        else:
            np.testing.assert_allclose(got[:, f], want[:, f], rtol=1e-6, err_msg=f"field {f}")


@pytest.mark.parametrize(
    "overrides", [{}, {"trilinear_texture": True, "soft_scattering": True}],
    ids=["bitsum-nearest-hard", "trilinear-soft"],
)
def test_march_plain_matches_pallas(traced, overrides):
    _, mats, segs, vol, port_segs, port_mats = traced
    ref_cfg, cfg = both_configs(transducer_elements=32, samples_per_element=2, **overrides)
    want = np.asarray(
        ref_march.march_and_accumulate_pallas(segs, mats, vol, ref_cfg, interpret=True))
    soa = march.pack_segments(port_segs, port_mats, cfg, cfg.rf_cols)
    seeds = torch.as_tensor(np.asarray(vol["seeds"]).astype(np.int64))
    got = to_np(march.march_cuda(soa, seeds, cfg, cfg.rf_cols))  # CPU tensor: the plain version
    assert got.shape == (cfg.rf_rows, cfg.rf_cols) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_scatter_march_matches_reference(traced):
    (ref_cfg, cfg), mats, segs, vol, port_segs, port_mats = traced
    want = np.asarray(ref_sim.march_and_accumulate(segs, mats, vol, ref_cfg))
    seeds = torch.as_tensor(np.asarray(vol["seeds"]).astype(np.int64))
    got = to_np(simulator.march_and_accumulate(port_segs, port_mats, {"seeds": seeds}, cfg))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    plain = to_np(march.march_plain(march.pack_segments(port_segs, port_mats, cfg, cfg.rf_cols),
                                    seeds, cfg, cfg.rf_cols))
    np.testing.assert_allclose(plain, got, rtol=1e-4, atol=1e-5)
