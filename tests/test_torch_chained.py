"""The chained batch (``Simulator.make_chained_batch``) on the CPU, the
capture repairs it needed, ``bench_torch.py`` without a card, and the C++
baseline's driver (``mcray_tpu_torch/utils/ref_baseline.py``).

``make_chained_batch(batch, n_chain)`` renders ``n_chain`` steps of
``batch`` frames keyed as the reference keys them (``fold_in(PRNGKey(seed0),
carry + i * batch + b)`` in uint32) and returns the last step's B-modes; on
the card each step is replayed from a CUDA graph
(``tests/test_torch_cuda.py``), on the CPU it runs eagerly. Against the
reference's ``make_chained_batch`` (a jitted ``lax.scan`` over a ``vmap``)
the tolerance is the whole-frame one of ``tests/test_torch_batch.py`` (rtol
1e-4, atol 1e-5, the B-mode clamped at 0 as the port's is). Which seed0
can serve was settled by ``tests/chained_reference_modes.py`` (32 elements x
2 paths, seed0 0-7; the reference jitted and under ``jax.disable_jit()``,
every op rounded as the port rounds it; the port in its listed and its
brute closest hit): 0, 3, 5, 6 and 7 agree in all four within 3.6e-7. For
1 and 4 the op-by-op reference agrees with both of the port's modes within
1.2e-7 and the jitted one parts by 0.12 and 0.39: its FMA-contracted
edge-grazing rays (``ROADMAP.md``, reference-side defects). For 2 the
port's brute mode agrees with the op-by-op reference within 1.8e-7 and its
listed mode parts by 0.19: a ray meets two triangles at one t, bitwise,
and the two closest hits break the tie differently in both packages
(``test_a_tied_hit_parts_the_brute_and_listed_closest_hits``). The
reference runs the brute closest hit on the CPU; the port runs the listed
one at the sphere's 2,220 triangles, as the reference does on the TPU. So
no seed0 parts for the chained keying or carry.

The module takes ~35 s on one CPU thread, ~6 s of it the reference's
compilation and ~3 s the C++ baseline's build.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import ROOT, SPHERE_SCENE, both_configs, to_np
from mcray_tpu.models.simulator import Simulator as RefSimulator
from mcray_tpu.ops import geometry as ref_geometry
from mcray_tpu.ops.pallas.intersect import intersect_closest_listed as ref_intersect_closest_listed
from mcray_tpu.ops.pallas.intersect import pack_tris_culled
from mcray_tpu.scene.compile import load_and_compile as ref_load_and_compile
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.ops import geometry, texture
from mcray_tpu_torch.ops.cuda.intersect_listed import intersect_closest_listed
from mcray_tpu_torch.probe import transducer
from mcray_tpu_torch.scene.compile import load_and_compile
from mcray_tpu_torch.utils import ref_baseline, rng

SEED0 = 3  # its last step's frames graze no edge and tie no hit at 32 x 2 (the docstring)


@functools.lru_cache(maxsize=None)
def _simulator() -> Simulator:
    _, cfg = both_configs(transducer_elements=32, samples_per_element=2)
    return Simulator(load_and_compile(SPHERE_SCENE), cfg, device="cpu", seed=1)


@pytest.mark.parametrize("seed0", [0, 7, 2**31 - 1])
def test_step_keys_equal_the_reference_ids(seed0):
    """Step i's frame keys against ``vmap(fold_in, (None, 0))(PRNGKey(seed0),
    carry + i * batch + arange(batch))`` in uint32, bitwise, with ``carry``
    0 and near 2**32 (the ids wrap). ~1 s."""
    chained = _simulator().make_chained_batch(3, 4)
    chained.key.copy_(rng.prng_key(seed0))
    key = jax.random.PRNGKey(seed0)
    for carry in (0, 2**32 - 5):
        for i in (0, 1, 3):
            chained.carry.fill_(carry)
            chained.i.fill_(i)
            ids = jnp.uint32(carry) + jnp.uint32(i) * jnp.uint32(3) + jnp.arange(
                3, dtype=jnp.uint32)
            want = np.asarray(jax.vmap(jax.random.fold_in, (None, 0))(key, ids))
            np.testing.assert_array_equal(to_np(chained.step_keys()), want.astype(np.int64))


def test_chained_batch_matches_the_reference():
    """``make_chained_batch(2, 2)`` of SEED0 against the reference's at rtol
    1e-4, atol 1e-5. ~8 s."""
    ref_cfg, _ = both_configs(transducer_elements=32, samples_per_element=2)
    ref = RefSimulator(ref_load_and_compile(SPHERE_SCENE, ref_cfg, with_bvh=False), ref_cfg,
                       seed=1)
    sim = _simulator()
    want = np.maximum(np.asarray(ref.make_chained_batch(2, 2)(SEED0)), 0.0)
    got = sim.make_chained_batch(2, 2)(SEED0)
    assert got.shape == (2, sim.cfg.bmode_rows, sim.cfg.bmode_cols)
    np.testing.assert_allclose(to_np(got), want, rtol=1e-4, atol=1e-5)
    assert float(got.std()) > 0


def test_a_tied_hit_parts_the_brute_and_listed_closest_hits():
    """Why seed0 2 cannot serve the parity test (the module's docstring): in
    the first frame of its last step, path 35's bounce-1 ray meets triangles
    1070 and 1167 at one t, bitwise, when every op is rounded (the port; the
    reference under ``jax.disable_jit()``). The brute closest hit (the
    reference's on the CPU) gives the tie to the lower index in both
    packages; the listed mode (the port's at 2,220 triangles, the
    reference's on the TPU) gives it to 1167 in both, the reference's listed
    kernel run in interpret mode on the same bounce's rays and clusters.
    Each winner is read from its hit's normal, which for these two mirror
    triangles differs in sign across the plane z = 0. ~9 s."""
    ref_cfg, _ = both_configs(transducer_elements=32, samples_per_element=2)
    sim = _simulator()
    rays = sim.render_frame(rng.fold_in(rng.prng_key(2), 2))["segments"]["rays"][1]
    o, s = rays[0:3].T.contiguous(), rays[3:6].T.contiguous()
    soa = sim.scene["tri_soa"]
    t, valid = geometry._moller_trumbore(o[35, None, None], s[35, None, None], soa[0:3].T[None],
                                         soa[3:6].T[None], soa[6:9].T[None])
    t = torch.where(valid, t, geometry.NO_HIT_T)[0]
    assert t[1070] == t[1167] == t.min() and int((t == t.min()).sum()) == 2

    pack = ref_load_and_compile(SPHERE_SCENE, ref_cfg)
    ref_packed = pack_tris_culled(pack.tris, pack.tri_mesh_id, pack.bvh.tri_order,
                                  sort_origin=pack.transducer_position, tile_t=128)
    oj, sj = jnp.asarray(to_np(o)), jnp.asarray(to_np(s))
    with jax.disable_jit():
        ref_brute = ref_geometry.intersect_closest(oj, sj, jnp.asarray(pack.tris),
                                                   jnp.asarray(pack.tri_mesh_id))
        ref_listed = ref_intersect_closest_listed(oj, sj, ref_packed, interpret=True,
                                                  tile_r=sim.intersect_tile_r)
    port_listed = intersect_closest_listed(o, s, sim.culled_tris[0], tile_r=sim.intersect_tile_r)
    _, port_idx = geometry.closest_hit(o, s, soa)
    assert int(port_idx[35]) == 1070

    def normal(i):  # the face normal oriented toward the ray's origin, as a hit reports it
        n = geometry.normalize(geometry.cross3(soa[3:6, i], soa[6:9, i]))
        return to_np(-n if float(geometry.dot3(n, s[35])) > 0.0 else n)

    for hits, tri in ((ref_brute, 1070), (ref_listed, 1167), (port_listed, 1167)):
        np.testing.assert_allclose(to_np(hits["normal"])[35], normal(tri), rtol=1e-6, atol=1e-6)
    assert np.abs(normal(1070) - normal(1167)).max() > 0.1


def test_last_step_equals_render_frames_of_its_keys():
    """The last of 3 steps bitwise ``render_frames`` of its keys; ``i`` and
    ``carry`` as the chain left them; a call with another seed0, then SEED0
    again, gives each seed's frames (no state carried between calls); a
    chain of no steps raises. ~7 s."""
    sim = _simulator()
    chained = sim.make_chained_batch(2, 3)

    def eager(seed0):
        keys = rng.fold_in(rng.prng_key(seed0), 2 * 2 + torch.arange(2))
        return sim.render_frames(keys)["bmode"]

    first = chained(SEED0).clone()
    assert int(chained.i) == 3 and int(chained.carry) == 0
    assert torch.equal(first, eager(SEED0))
    other = chained(11).clone()
    assert torch.equal(other, eager(11))
    assert not torch.equal(other, first)
    assert torch.equal(chained(SEED0), first)
    with pytest.raises(ValueError, match="must be positive"):
        sim.make_chained_batch(2, 0)


def test_capture_repairs_keep_every_result():
    """``fdiv``, ``normal_from_uniform`` and the linear probe's axes as they
    are now (a divisor made once per value, dtype and device; the axes made
    on the device) against the expressions they replace (a tensor made from
    the Python number at every call), bitwise. ~1 s."""
    gen = np.random.default_rng(0)
    x = torch.from_numpy(gen.uniform(-50.0, 50.0, 4096).astype(np.float32))
    _, cfg = both_configs(transducer_elements=32, samples_per_element=2)
    for d in (100.0, cfg.speed_of_sound, cfg.rf_row_dt_us, cfg.axial_resolution_mm, 3.0, 7):
        assert torch.equal(texture.fdiv(x, d), x / torch.tensor(d, dtype=x.dtype)), d
        assert torch.equal(texture.fdiv(x.double(), d),
                           x.double() / torch.tensor(d, dtype=torch.float64)), d
    assert rng.scalar(100.0, torch.float32, x.device) is rng.scalar(100.0, torch.float32,
                                                                    x.device)

    u = torch.from_numpy(gen.uniform(0.0, 1.0, 4096).astype(np.float32))
    u[:4] = torch.tensor([0.0, 1.0 - 2.0**-24, 0.5, 2.0**-24])
    lo = torch.tensor(rng._MINUS_ONE_OPEN, dtype=torch.float32)
    assert torch.equal(rng.normal_from_uniform(u),
                       rng._SQRT2 * torch.erfinv(torch.maximum(lo, u * (1.0 - lo) + lo)))

    _, lin = both_configs(transducer_elements=32, samples_per_element=2, probe_type="linear")
    pos, ang = torch.tensor([0.1, -0.2, 0.3]), torch.tensor([[0.0, 0.0, 0.0], [5.0, -3.0, 20.0]])
    got = transducer.element_layout_linear(pos, ang, lin)
    axes = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    rotated = transducer._rotated(axes, ang)
    n = lin.transducer_elements
    offsets = (transducer._arange(n, pos) - (n - 1) / 2.0) * (lin.element_separation_mm / 10.0)
    want = pos[..., None, :] + offsets[:, None] * rotated[..., 0, :][..., None, :]
    assert torch.equal(got[0], want)
    assert torch.equal(got[1], rotated[..., 1, :][..., None, :].expand(want.shape))


def test_bench_torch_exits_nonzero_without_a_card():
    """``bench_torch.py`` needs the card: here it exits non-zero and prints
    no result. ~4 s."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "needs an NVIDIA GPU" in proc.stderr


def test_ref_baseline_driver_runs(tmp_path):
    """The C++ baseline built with ``native/Makefile``'s flags into
    ``tmp_path`` (nothing under ``native/``) renders a few frames of the
    sphere at 32 x 2: every path traced, a finite B-mode with texture, a
    positive frame time. ~4 s."""
    cxx, flags = ref_baseline.makefile_flags()
    assert cxx == "g++" and "-O3" in flags and "-fPIC" in flags
    native_before = sorted(os.listdir(ref_baseline.NATIVE))
    lib = ref_baseline.build(tmp_path)
    assert lib.parent == tmp_path and lib.exists()
    assert ref_baseline.build(tmp_path) == lib  # built once per hash
    assert sorted(os.listdir(ref_baseline.NATIVE)) == native_before

    _, cfg = both_configs(transducer_elements=32, samples_per_element=2)
    pack = load_and_compile(SPHERE_SCENE)
    out = ref_baseline.run(pack, cfg, frames=2, lib_path=lib)
    assert out["frame_ms"] > 0 and out["rays_per_s"] > 0
    assert out["ray_queries"] >= cfg.transducer_elements * cfg.samples_per_element
    assert out["segments"] > 0 and out["collisions"] > 0
    bmode = out["bmode"]
    assert bmode.shape == (cfg.bmode_rows, cfg.bmode_cols)
    assert np.isfinite(bmode).all() and bmode.std() > 0
