"""The port's whole frame against mcray_tpu's, and the port's JAX-free import.

Two ways of giving both packages one randomness: the port's ``render`` is
handed the reference's draws and texture seeds (the first tests), or each
package's entry point gets the seed alone and derives keys, draws and seeds
itself (``test_render_frame_from_the_seed_alone_matches_reference``, in
listed and in grouped mode: the port's ``Simulator.render_frame(seed)``
against the reference's jitted frame of ``PRNGKey(seed)``).

``mcray_tpu.models.simulator.render`` with its CPU defaults (jnp brute
intersect, jnp scatter march, jnp postproc, map_coordinates) renders the
sphere under ``small_test_config()``; the port's ``render`` gets the same
draws and texture seeds and runs its kernels' plain versions. The listed
frame does the same through the reference's default large-scene closest
hit: its listed Pallas kernel in interpret mode on 512-ray packets and
128-triangle clusters, against the port's listed path on the same packing.

Discrete outputs (segment validity and media ids) must be equal path by
path. One mechanism is allowed to break that, and each instance is checked:
a ray that passes within float noise of a triangle edge — the sphere's
equator edges lie in the probe plane z = 0 — where XLA's CPU code (which
contracts Möller–Trumbore's multiply-adds into FMAs) and torch (which
rounds every op) can disagree on which of two triangles, or whether either,
is hit (ROADMAP queue 3). Such a path must graze an edge at the bounce where
it first diverges; its RF columns, and the B-mode pixels that read them
through the PSF, are left out of the image comparison. Float segment
fields compare at rtol 1e-5: scalars elementwise (atol 1e-6), points and
directions by vector norm (atol 1e-5), because a missed ray's end point
lies up to ~1e9 units out along its direction and carries the direction's
last-ulp error scaled up. rf_raw and bmode compare at rtol 1e-4, atol 1e-5.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import SPHERE_SCENE, both_configs, reference_draws, to_np
from mcray_tpu.models import simulator as ref_sim
from mcray_tpu.ops import geometry as ref_geometry
from mcray_tpu.ops import imaging as ref_imaging
from mcray_tpu.ops import texture as ref_texture
from mcray_tpu.ops.pallas.intersect import intersect_closest_pallas, pack_tris_culled
from mcray_tpu.scene.compile import load_and_compile
from mcray_tpu_torch.models import simulator
from mcray_tpu_torch.ops import clusters, geometry
from mcray_tpu_torch.ops.cuda.scanconv import scan_maps
from mcray_tpu_torch.scene.compile import load_and_compile as port_load_and_compile
from mcray_tpu_torch.utils.convert import from_reference

VECTOR_FIELDS = ("from", "to", "direction")
SCALAR_FIELDS = ("reflected", "initial", "attenuation", "distance")


@pytest.fixture(scope="module")
def reference_setup():
    ref_cfg, cfg = both_configs()
    pack = load_and_compile(SPHERE_SCENE, ref_cfg, with_bvh=False)
    return (ref_cfg, cfg), pack


def _reference_frame(cfg, pack, seed, **trace_kw):
    """The reference frame for ``seed`` and its segment tensor, from one
    jitted program (as the reference's Simulator runs it); ``trace_kw``
    choose its closest hit."""
    scene = {k: jnp.asarray(v) for k, v in pack.trace_tables().items()}
    args = (jnp.asarray(pack.materials), jnp.asarray(pack.transducer_position),
            jnp.asarray(pack.transducer_angles), scene, jnp.asarray(pack.spacing),
            jnp.int32(pack.starting_material))
    volume = ref_texture.make_texture_volume(jax.random.PRNGKey(seed ^ 0x5CA77E7), cfg)
    maps = ref_imaging.scan_conversion_maps(cfg)

    @jax.jit
    def frame(key):
        segments = ref_sim.trace_paths(jax.random.fold_in(key, 0), *args, cfg, **trace_kw)
        out = ref_sim.render(key, *args, volume, (jnp.asarray(maps[0]), jnp.asarray(maps[1])), cfg,
                             **trace_kw)
        return segments, {k: out[k] for k in ("rf_raw", "bmode")}

    segments, images = frame(jax.random.PRNGKey(seed))
    return (
        {k: np.asarray(v) for k, v in segments.items()},
        {k: np.asarray(v) for k, v in images.items()},
        np.asarray(volume["seeds"]),
        maps,
    )


def _grazes_an_edge(tris, ray, tol=1e-6) -> bool:
    """Whether the segment crosses the plane of some triangle within ``tol``
    (barycentric) of one of its edges, in float64."""
    o, s = ray[:3].astype(np.float64), ray[3:].astype(np.float64)
    t64 = tris.astype(np.float64)
    v0, e1, e2 = t64[:, 0], t64[:, 1] - t64[:, 0], t64[:, 2] - t64[:, 0]
    p = np.cross(s, e2)
    det = np.einsum("ij,ij->i", e1, p)
    ok = np.abs(det) > 1e-12
    det = np.where(ok, det, 1.0)
    tv = o - v0
    q = np.cross(tv, e1)
    u = np.einsum("ij,ij->i", tv, p) / det
    v = (q @ s) / det
    t = np.einsum("ij,ij->i", e2, q) / det
    margin = np.minimum(np.minimum(u, v), 1.0 - u - v)
    return bool(np.any(ok & (t > 0) & (t < 1) & (np.abs(margin) < tol)))


def _check_frame(cfgs, pack, seed, ref_trace_kw=None, port_trace_kw=None, port_sim=None):
    """Render ``seed`` in both packages (each with its own config of
    ``cfgs``) and hold the port's frame to the reference's under the
    edge-grazing rule of the module docstring. The port renders from the
    reference's draws and seeds, or, given ``port_sim`` (a ``Simulator``
    built with ``seed``), from the seed alone."""
    ref_cfg, cfg = cfgs
    ref_segments, ref_frame, seeds, maps = _reference_frame(ref_cfg, pack, seed,
                                                            **(ref_trace_kw or {}))
    n = cfg.transducer_elements * cfg.samples_per_element
    port_maps = scan_maps(maps[0], maps[1], cfg.rf_rows, cfg.rf_cols)
    if port_sim is not None:
        np.testing.assert_array_equal(to_np(port_sim.seeds), seeds.astype(np.int64))
        out = port_sim.render_frame(seed)
    else:
        state = from_reference(pack, pack.materials, seeds,
                               reference_draws(seed, n, cfg.max_depth), device="cpu")
        out = simulator.render(
            state["draws"], state["seeds"], state["materials"], state["position"],
            state["angles"], state["scene"], state["spacing"], state["starting_material"],
            port_maps, cfg, **(port_trace_kw or {}),
        )
    segments = {k: to_np(v) for k, v in out["segments"].items()}

    # paths whose segments disagree anywhere (discrete or float)
    bad = (segments["valid"] != ref_segments["valid"]) | (
        segments["media_id"] != ref_segments["media_id"])
    for key in VECTOR_FIELDS:
        a, b = segments[key], ref_segments[key]
        bad |= np.linalg.norm(a - b, axis=-1) > 1e-5 * np.linalg.norm(b, axis=-1) + 1e-5
    for key in SCALAR_FIELDS:
        bad |= ~np.isclose(segments[key], ref_segments[key], rtol=1e-5, atol=1e-6)
    diverged = np.nonzero(bad.any(axis=0))[0]
    assert len(diverged) <= n // 20, f"{len(diverged)} of {n} paths diverge"
    for p in diverged:
        d = int(np.nonzero(bad[:, p])[0][0])
        assert _grazes_an_edge(pack.tris, segments["rays"][d][:, p]), (
            f"path {p} diverges at bounce {d} on a ray that grazes no triangle edge")

    # image comparison away from the columns the diverged paths write
    cols = set(int(p) // cfg.samples_per_element for p in diverged)
    rf_cols = np.ones(cfg.rf_cols, bool)
    rf_cols[list(cols)] = False
    np.testing.assert_allclose(
        to_np(out["rf_raw"])[:, rf_cols], ref_frame["rf_raw"][:, rf_cols], rtol=1e-4, atol=1e-5
    )
    # the lateral PSF reads columns c..c+L-1, so env column c' sees raw c' .. c'+L-1
    env_ok = np.array([rf_cols[c : c + cfg.psf_lateral_size].all() for c in range(cfg.rf_cols)])
    c0 = to_np(port_maps.table)[:, 3, : cfg.bmode_cols].astype(int)
    pix_ok = env_ok[np.clip(c0, 0, cfg.rf_cols - 1)] & env_ok[np.clip(c0 + 1, 0, cfg.rf_cols - 1)]
    # the port clamps the B-mode at 0, as the reference's kernel path does
    np.testing.assert_allclose(
        to_np(out["bmode"])[pix_ok], np.maximum(ref_frame["bmode"], 0.0)[pix_ok],
        rtol=1e-4, atol=1e-5,
    )
    assert pix_ok.mean() > 0.8


@pytest.mark.parametrize("seed", [0, 1])
def test_render_matches_reference(reference_setup, seed):
    cfgs, pack = reference_setup
    _check_frame(cfgs, pack, seed)


@pytest.mark.parametrize("seed", [0, 1])
def test_listed_render_matches_reference(reference_setup, seed):
    cfgs, pack = reference_setup
    order = load_and_compile(SPHERE_SCENE, cfgs[0], with_bvh=True).bvh.tri_order
    args = (pack.tris, pack.tri_mesh_id, order)
    kw = {"sort_origin": pack.transducer_position, "tile_t": 128}
    _check_frame(
        cfgs, pack, seed,
        ref_trace_kw={"culled_tris": (pack_tris_culled(*args, **kw), "listed"),
                      "intersect_tile_r": 512, "intersect_interpret": True},
        port_trace_kw={"culled_tris": (clusters.pack_tris_culled(*args, **kw), "listed"),
                       "intersect_tile_r": 512},
    )


SEED_ALONE = 1  # at 32 elements this seed's paths graze no triangle edge


@functools.lru_cache(maxsize=None)
def _port_simulator(mode):
    _, cfg = both_configs(transducer_elements=32, samples_per_element=2)
    return simulator.Simulator(port_load_and_compile(SPHERE_SCENE), cfg, device="cpu",
                               seed=SEED_ALONE, intersect_mode=mode)


@pytest.mark.parametrize("mode", ["listed", "grouped"])
def test_render_frame_from_the_seed_alone_matches_reference(mode):
    """``Simulator.render_frame(seed)`` of the port against the reference's
    frame of the same seed: nothing crosses between the packages but the
    seed. The reference runs its listed or grouped Pallas kernel in
    interpret mode, on the packing and packets its Simulator would choose
    (128-triangle clusters, 512-ray packets)."""
    cfgs = both_configs(transducer_elements=32, samples_per_element=2)
    pack = load_and_compile(SPHERE_SCENE, cfgs[0], with_bvh=True)
    packed = pack_tris_culled(pack.tris, pack.tri_mesh_id, pack.bvh.tri_order,
                              sort_origin=pack.transducer_position, tile_t=128)
    sim = _port_simulator(mode)
    assert sim.culled_tris[1] == mode and sim.intersect_tile_r == 512
    _check_frame(cfgs, pack, SEED_ALONE, port_sim=sim,
                 ref_trace_kw={"culled_tris": (packed, mode), "intersect_tile_r": 512,
                               "intersect_interpret": True})


def test_grouped_frame_equals_listed_frame():
    """Inside the port the two modes find the same closest hits, so one seed
    gives one frame: hit, t-derived fields and images equal bitwise."""
    a = _port_simulator("grouped").render_frame(SEED_ALONE)
    b = _port_simulator("listed").render_frame(SEED_ALONE)
    assert int(a["segments"]["valid"].sum()) > 100
    for key in ("valid", "media_id", "to", "reflected", "rays"):
        assert torch.equal(a["segments"][key], b["segments"][key]), key
    for key in ("rf_raw", "bmode"):
        assert torch.equal(a[key], b[key]), key
    again = _port_simulator("grouped").render_frame(SEED_ALONE)
    assert torch.equal(again["bmode"], a["bmode"])  # one seed, one frame


def test_edge_grazing_ray_splits_the_reference(reference_setup):
    """The path that diverges under seed 1 (path 51, bounce 1) grazes the
    shared edge of two sphere triangles. On that ray the reference decides
    differently by execution mode: jitted (XLA contracts Möller–Trumbore's
    multiply-adds into FMAs) it hits triangle 1032, as its Pallas kernel in
    interpret mode does; op by op (``jax.disable_jit``) it misses 1032 and
    hits triangle 10 further on. The port, which rounds every op, decides as
    the reference's op-by-op mode does, bitwise."""
    (_, cfg), pack = reference_setup
    n = cfg.transducer_elements * cfg.samples_per_element
    state = from_reference(pack, pack.materials, np.zeros(2), reference_draws(1, n, cfg.max_depth),
                           device="cpu")
    segments = simulator.trace_paths(
        state["draws"], state["materials"], state["position"], state["angles"], state["scene"],
        state["spacing"], state["starting_material"], cfg)
    ray = to_np(segments["rays"][1][:, 51])
    assert _grazes_an_edge(pack.tris, ray)
    o, s = jnp.asarray(ray[None, :3]), jnp.asarray(ray[None, 3:])
    tris, mid = jnp.asarray(pack.tris), jnp.asarray(pack.tri_mesh_id)

    def decide(out):
        return bool(out["hit"][0]), float(out["t"][0]), int(out["mesh_id"][0])

    jitted = decide(jax.jit(ref_geometry.intersect_closest)(o, s, tris, mid))
    with jax.disable_jit():
        op_by_op = decide(ref_geometry.intersect_closest(o, s, tris, mid))
    pallas = decide(intersect_closest_pallas(o, s, tris, mid, interpret=True))
    best_t, best_idx = geometry.closest_hit(torch.as_tensor(ray[None, :3]),
                                            torch.as_tensor(ray[None, 3:]), state["scene"]["tri_soa"])
    port = (bool(best_t[0] < 1.5), float(best_t[0]), int(pack.tri_mesh_id[int(best_idx[0])]))

    assert port == op_by_op
    assert int(best_idx[0]) == 10
    assert jitted[0] and pallas[0] and jitted[1] < op_by_op[1]  # the nearer, grazed triangle
    np.testing.assert_allclose(pallas[1], jitted[1], rtol=1e-6)
    assert jitted != op_by_op


def test_port_imports_no_jax(tmp_path):
    """A 16-element x 2-sample frame renders on the CPU without importing jax."""
    code = (
        "import sys\n"
        "import torch\n"
        "from mcray_tpu_torch.config import small_test_config\n"
        "from mcray_tpu_torch.models.simulator import Simulator\n"
        "from mcray_tpu_torch.scene.compile import load_and_compile\n"
        f"pack = load_and_compile({SPHERE_SCENE!r})\n"
        "cfg = small_test_config(transducer_elements=16, samples_per_element=2)\n"
        "b = Simulator(pack, cfg, device='cpu').render_frame(3)['bmode']\n"
        "assert b.shape == (cfg.bmode_rows, cfg.bmode_cols) and bool(torch.isfinite(b).all())\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "print('ok')\n"
    )
    root = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
