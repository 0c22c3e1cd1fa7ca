"""mcray_tpu_torch.ops.physics against mcray_tpu.ops.physics.

``hit_boundary`` gets the reference's own draws on both sides. Integer and
boolean outputs (media ids, the roulette choice) must be equal; float
outputs compare at rtol 1e-5 (pow/sqrt/sin/cos round their last ulp
differently in XLA and torch), atol 1e-6 for components near zero. Where a
ray's refraction grazes (``refr_sq`` exactly 0), the port's gradient in the
material table stays finite, where the reference's sqrt has an infinite
derivative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import both_configs, reference_draws, to_np, to_torch
from mcray_tpu.ops import physics as ref
from mcray_tpu_torch.ops import physics
from mcray_tpu_torch.utils import rng

FLOAT_OUT = ("back_intensity", "new_from", "new_direction", "new_intensity")
EXACT_OUT = ("new_media_id", "new_media_outside_id", "chose_reflection")


@pytest.mark.parametrize("bug_compat", [False, True], ids=["id-transition", "bug-compat"])
def test_hit_boundary_matches(rng, sphere_pack, bug_compat):
    pack, _ = sphere_pack
    ref_cfg, cfg = both_configs(bug_compat_material_transition=bug_compat)
    n = 512
    m, k = pack.n_materials, pack.mesh_mat_inside.shape[0]
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    inputs = dict(
        direction=d,
        hit_point=rng.uniform(-5, 5, (n, 3)).astype(np.float32),
        surface_normal=nrm,
        intensity=rng.uniform(1e-6, 0.5, n).astype(np.float32),
        media_id=rng.integers(0, m, n).astype(np.int32),
        media_outside_id=np.where(rng.random(n) < 0.3, rng.integers(0, m, n), -1).astype(np.int32),
        mesh_id=rng.integers(-1, k, n).astype(np.int32),
    )
    # one bounce's slice of the reference frame's draws
    draws = {key: v[3] for key, v in reference_draws(5, n, 4).items()}
    tables = (pack.materials, pack.mesh_mat_inside, pack.mesh_mat_outside, pack.mesh_is_vascular)

    want = ref.hit_boundary(
        None, *(jnp.asarray(v) for v in inputs.values()), *(jnp.asarray(t) for t in tables),
        ref_cfg, draws={key: jnp.asarray(v) for key, v in draws.items()},
    )
    got = physics.hit_boundary(
        *(to_torch(v) for v in inputs.values()), *(to_torch(t) for t in tables), cfg,
        draws={key: to_torch(v) for key, v in draws.items()},
    )
    for key in EXACT_OUT:
        np.testing.assert_array_equal(to_np(got[key]), np.asarray(want[key]), err_msg=key)
    for key in FLOAT_OUT:
        np.testing.assert_allclose(
            to_np(got[key]), np.asarray(want[key]), rtol=1e-5, atol=1e-6, err_msg=key
        )


def test_draw_bounce_randoms_distributions():
    path_keys = rng.fold_in(rng.prng_key(3), torch.arange(5000))
    draws = physics.draw_bounce_randoms(path_keys, 4)
    assert set(draws) == {"q_normal", "angle_u", "axis_u", "radius_u", "roulette_u"}
    for key, v in draws.items():
        assert v.shape == (4, 5000) and v.dtype == torch.float32
        if key != "q_normal":
            assert float(v.min()) >= 0.0 and float(v.max()) < 1.0
            assert abs(float(v.mean()) - 0.5) < 0.02
    assert float(draws["angle_u"].min()) >= 1e-12
    q = draws["q_normal"]
    assert abs(float(q.mean())) < 0.03 and abs(float(q.std()) - 1.0) < 0.03
    # keyed: the same keys give the same draws, another depth count a prefix
    again = physics.draw_bounce_randoms(path_keys, 2)
    for key, v in again.items():
        assert torch.equal(v, draws[key][:2]), key


def test_hit_boundary_gradient_is_finite_where_the_refraction_is_grazing():
    """A ray that grazes a boundary between two media of equal impedance has
    ``refr_sq`` exactly 0, where sqrt's derivative is infinite: the gradient
    in the material table stays finite (the refracted angle's value, 0, is
    unchanged). Without the guard one such ray turned a fit's table to NaN
    (the card, ``sphere_soft.fit``)."""
    _, cfg = both_configs()
    n = 4
    materials = torch.tensor([[1.5, 0.5, 0.1, 1.0, 0.2, 1.0, 1e6, 0.0],
                              [1.5, 0.7, 0.2, 1.0, 0.3, 1.0, 1e6, 0.0]], requires_grad=True)
    direction = torch.tensor([[1.0, 0.0, 0.0]]).expand(n, 3)
    normal = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3)
    draws = {"angle_u": torch.ones(n), "axis_u": torch.full((n,), 0.3),
             "radius_u": torch.full((n,), 0.5), "roulette_u": torch.full((n,), 0.5)}
    ids = torch.zeros(n, dtype=torch.int32)
    out = physics.hit_boundary(direction, torch.zeros(n, 3), normal, torch.full((n,), 0.2), ids,
                               torch.full((n,), -1, dtype=torch.int32), ids, materials,
                               torch.ones(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
                               torch.zeros(1, dtype=torch.bool), cfg, draws)
    ratio = materials[0, 0] / materials[1, 0]
    incidence = torch.abs((direction * normal).sum(dim=1))
    assert float(ratio) == 1.0 and bool(((1.0 - ratio * ratio * (1.0 - incidence ** 2)) == 0).all())
    loss = sum(out[k].sum() for k in ("back_intensity", "new_direction", "new_intensity"))
    loss.backward()
    assert bool(torch.isfinite(materials.grad).all())
