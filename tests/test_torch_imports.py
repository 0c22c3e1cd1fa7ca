"""The port stands alone: no module of ``mcray_tpu_torch`` (nor
``chip_smoke.py``, ``bench_torch.py``, ``cluster_timing.py``,
``examples/quickstart_torch.py`` and the gloo ranks'
``tests/torch_shard_worker.py``) imports ``jax`` or anything of
``mcray_tpu``, and the copies it keeps of the reference's JAX-free modules
(the config, the loader, the VTP converter) agree with them."""

from __future__ import annotations

import ast
import base64
import dataclasses
import os
import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest

from _torch_port import SPHERE_SCENE, both_configs
from mcray_tpu import config as ref_config
from mcray_tpu.scene import compile as ref_compile
from mcray_tpu.utils import vtp_to_obj as ref_vtp_to_obj
from mcray_tpu_torch import config as port_config
from mcray_tpu_torch.scene import compile as port_compile
from mcray_tpu_torch.utils import vtp_to_obj as port_vtp_to_obj

ROOT = pathlib.Path(__file__).resolve().parents[1]
# run on the card, not imported
SCRIPTS = [ROOT / "cluster_timing.py", ROOT / "chip_smoke.py", ROOT / "bench_torch.py",
           ROOT / "examples" / "quickstart_torch.py",
           ROOT / "tests" / "torch_shard_worker.py"]
PORT_FILES = sorted((ROOT / "mcray_tpu_torch").rglob("*.py")) + SCRIPTS
FORBIDDEN = ("jax", "mcray_tpu")
DERIVED = ("axial_resolution_mm", "axial_resolution_um", "max_travel_time_us", "rf_rows",
           "rf_cols", "rf_row_dt_us", "march_dt_us", "max_march_steps",
           "transducer_amplitude_rad", "element_separation_mm")


def _imported_names(path: pathlib.Path):
    """Every absolute module name the file imports, at any depth."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_file_imports_no_jax_and_no_reference(path):
    bad = [name for name in _imported_names(path) if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_with_jax_and_reference_blocked(tmp_path):
    """In a fresh interpreter whose import system raises on ``jax`` and
    ``mcray_tpu``, every module of the port imports."""
    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts) for p in PORT_FILES[:-len(SCRIPTS)]]
    modules = [m.removesuffix(".__init__") for m in modules]
    code = (
        "import importlib, importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"assert not [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        f"print(len({modules!r}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) == len(modules) > 30


@pytest.mark.parametrize("small", [False, True], ids=["SimConfig", "small_test_config"])
def test_config_copy_matches_reference(small):
    ref, port = both_configs(small=small)
    assert type(ref) is not type(port)
    assert [f.name for f in dataclasses.fields(ref)] == [f.name for f in dataclasses.fields(port)]
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    for name in DERIVED:
        assert getattr(ref, name) == getattr(port, name), name
    assert dataclasses.asdict(ref_config.DEFAULT_CONFIG) == dataclasses.asdict(
        port_config.DEFAULT_CONFIG)
    assert hash(port) == hash(dataclasses.replace(port))  # hashable: ops cache by it


def test_loader_copy_compiles_the_same_sphere():
    ref_cfg, _ = both_configs()
    want = ref_compile.load_and_compile(SPHERE_SCENE, ref_cfg, with_bvh=True)
    got = port_compile.load_and_compile(SPHERE_SCENE, with_bvh=True)
    for field in ("tris", "tri_mesh_id", "materials", "mesh_mat_inside", "mesh_mat_outside",
                  "mesh_is_vascular", "transducer_position", "transducer_angles", "spacing"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert got.starting_material == want.starting_material
    np.testing.assert_array_equal(got.bvh.tri_order, want.bvh.tri_order)


def _vtp(points: np.ndarray, conn: np.ndarray, offsets: np.ndarray, fmt: str) -> str:
    """A PolyData VTP of ``points`` and polygons in ``fmt`` ("ascii" or
    "binary": base64 behind a 32-bit byte count)."""
    def array(a, dtype, attrs):
        a = np.asarray(a, dtype)
        if fmt == "ascii":
            text = " ".join(str(v) for v in a.ravel())
        else:
            raw = a.tobytes()
            text = base64.b64encode(struct.pack("<I", len(raw)) + raw).decode()
        return f'<DataArray type="{dtype.__name__.title()}" {attrs} format="{fmt}">{text}</DataArray>'

    return ('<?xml version="1.0"?><VTKFile type="PolyData"><PolyData>'
            f'<Piece NumberOfPoints="{len(points)}" NumberOfPolys="{len(offsets)}"><Points>'
            + array(points, np.float32, 'NumberOfComponents="3"') + "</Points><Polys>"
            + array(conn, np.int64, 'Name="connectivity"')
            + array(offsets, np.int64, 'Name="offsets"') + "</Polys></Piece></PolyData></VTKFile>")


@pytest.mark.parametrize("fmt", ["ascii", "binary"])
def test_vtp_converter_copy_matches_reference(tmp_path, fmt):
    rng = np.random.default_rng(3)
    points = rng.standard_normal((9, 3)).astype(np.float32)
    conn, offsets = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 0, 4, 8]), np.array([3, 7, 9, 12])
    path = tmp_path / f"mesh_{fmt}.vtp"
    path.write_text(_vtp(points, conn, offsets, fmt))
    got = port_vtp_to_obj.vtp_to_arrays(str(path))
    want = ref_vtp_to_obj.vtp_to_arrays(str(path))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], points)
    assert got[1].shape == (4, 3)  # a triangle, a quad (two, fanned), a line (none), a triangle
