"""The ``mega.chained`` cell, added as new files only: its mesh set is the
program's generated abdomen byte for byte at full size (615,176 triangles),
it reports the chained entry's metrics and its cluster packing's, and a run of it on the CPU, its
mesh set cut to ~3k triangles and its frames to the small acquisition,
comes out correct, and not correct when the chained batch returns its
previous answer. ~40 s."""

from __future__ import annotations

import hashlib
import os
import time

import pytest

from benchmark.harness import cell, meshes, runner
from benchmark.tests.helpers import SMALL
from benchmark.tests.test_bm_run import stale
from mcray_tpu_torch.models import simulator
from mcray_tpu_torch.scene import primitives

#: the metrics ``sphere.chained`` reports, in their order, and the new span's
MEGA_METRICS = ["device_busy_ms.chained", "torch_ops_ms.chained", "listed_kernel_ms.chained",
                "imaging_kernels_ms.chained", "frame_pct_of_roofline.chained", "draws_ms.chained",
                "prepass_ms.chained", "closest_hit_ms.chained", "bounce_physics_ms.chained",
                "march_ms.chained", "image_ms.chained", "graph_launch_ms.chained",
                "graph_nodes.chained", "scene_compile_s", "graph_capture_s", "cluster_pack_s.mega"]


def digests(directory) -> dict[str, str]:
    return {name: hashlib.sha256(open(os.path.join(directory, name), "rb").read()).hexdigest()
            for name in sorted(os.listdir(directory))}


def test_the_set_is_the_programs_abdomen_byte_for_byte(tmp_path):
    bench = meshes.ensure(cell.config("mega")["meshes"], str(tmp_path / "bench"))
    primitives.ensure_ircad_mega_assets(str(tmp_path / "program"))
    got = digests(bench)
    assert len(got) == 11 and got == digests(tmp_path / "program")
    faces = 0
    for name in got:
        with open(os.path.join(bench, name)) as f:
            faces += sum(line.startswith("f ") for line in f)
    assert faces == 615_176


def test_the_cell_reports_the_chained_metrics_and_its_packing():
    spec = cell.benchmark()
    assert [m["name"] for m in cell.per_layer(spec, "mega.chained")] == MEGA_METRICS
    assert [m["name"] for m in cell.per_layer(spec, "sphere.chained")] == MEGA_METRICS[:-1]
    assert {m["name"] for m in cell.end_to_end(spec, "mega.chained")} == {"frames_per_s",
                                                                          "setup_s"}


@pytest.fixture
def cut(monkeypatch, tmp_path):
    """The cell's mesh set cut to ~3k triangles, written under ``tmp_path``."""
    config = cell.config

    def small(name):
        conf = config(name)
        if name == "mega":
            conf["meshes"] = {**conf["meshes"], "tris_scale": 0.02}
        return conf

    monkeypatch.setattr(cell, "config", small)
    monkeypatch.setattr(runner, "MESH_ROOT", str(tmp_path))


def run():
    return runner.run_cell("mega.chained", 2**31 + 4343, 1.0, False,
                           t_start=time.perf_counter(), device="cpu", acquisition=SMALL,
                           mix={"batch": 2, "n_chain": 2})["result"]


def test_a_small_run_is_correct(cut, tmp_path):
    result = run()
    assert result["correct"] and result["failed"] == 0, result["check"]
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
    assert len(os.listdir(tmp_path / "mega")) == 11


def test_a_stale_answer_is_not_correct(cut, monkeypatch):
    monkeypatch.setattr(simulator.ChainedBatch, "__call__",
                        stale(simulator.ChainedBatch.__call__))
    assert not run()["correct"]
