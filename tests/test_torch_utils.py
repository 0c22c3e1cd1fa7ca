"""``render``'s reference keys, and the port's profiling and VTP utilities
against the reference's.

``render`` returns ``rf_conv`` and ``segments_valid`` as the reference's
does (``mcray_tpu/models/simulator.py:422-429``): on the CPU the plain
postproc runs, so ``rf_conv`` is the convolved image, held to the
reference's frame of the same seed at rtol 1e-5 / atol 1e-6, and
``segments_valid`` bitwise (``small_test_config()``, seed 0, which grazes no
edge). ``FrameMetrics`` gives the reference's summary keys and counters for
the same calls; ``device_trace`` writes a Chrome trace; ``vtp_to_obj``
converts the inline VTP of ``tests/test_cli.py``.
"""

import json
import time

import numpy as np
import torch

from _torch_port import SPHERE_SCENE, both_configs, to_np
from mcray_tpu.models.simulator import Simulator as RefSimulator
from mcray_tpu.scene.compile import load_and_compile as ref_load_and_compile
from mcray_tpu.utils import profiling as ref_profiling
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.scene.compile import load_and_compile
from mcray_tpu_torch.scene.obj import _load_obj_py
from mcray_tpu_torch.utils import profiling, vtp_to_obj

QUAD_VTP = (
    '<?xml version="1.0"?><VTKFile type="PolyData"><PolyData>'
    '<Piece NumberOfPoints="4" NumberOfPolys="1"><Points>'
    '<DataArray type="Float32" NumberOfComponents="3" format="ascii">'
    "0 0 0 1 0 0 1 1 0 0 1 0</DataArray></Points><Polys>"
    '<DataArray type="Int64" Name="connectivity" format="ascii">0 1 2 3</DataArray>'
    '<DataArray type="Int64" Name="offsets" format="ascii">4</DataArray>'
    "</Polys></Piece></PolyData></VTKFile>"
)


def test_render_returns_the_reference_keys():
    ref_cfg, cfg = both_configs()
    want = RefSimulator(ref_load_and_compile(SPHERE_SCENE, ref_cfg), ref_cfg).render_frame(0)
    got = Simulator(load_and_compile(SPHERE_SCENE), cfg, device="cpu").render_frame(0)
    assert set(want) <= set(got), set(want) - set(got)
    np.testing.assert_array_equal(to_np(got["segments_valid"]), np.asarray(want["segments_valid"]))
    np.testing.assert_allclose(to_np(got["rf_conv"]), np.asarray(want["rf_conv"]),
                               rtol=1e-5, atol=1e-6)
    # the plain postproc ran (the CPU): rf_conv is the convolved image, not rf_raw
    assert not torch.equal(got["rf_conv"], got["rf_raw"])


def _drive(metrics, sync):
    for _ in range(2):
        with metrics.stage("frame", sync=sync):
            time.sleep(0.001)
        with metrics.stage("trace") as box:
            box["sync"] = sync
        metrics.count("rays", 128)
    metrics.count("frames_dropped")


def test_frame_metrics_keys_match_the_reference(monkeypatch):
    want = ref_profiling.FrameMetrics()
    _drive(want, np.zeros(3))
    got = profiling.FrameMetrics()

    def no_wait(*args):
        raise AssertionError("waited on the card for a CPU tensor")

    monkeypatch.setattr(torch.cuda, "synchronize", no_wait)
    _drive(got, {"bmode": torch.zeros(3), "rf": [torch.ones(2)]})
    summary = got.summary()
    assert set(summary) == set(want.summary())
    assert summary["rays"] == 256 and summary["frames_dropped"] == 1
    assert summary["frame_ms"] >= 1.0 and summary["rays_per_s"] > 0
    assert json.loads(got.report()) == summary


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("matmul" in e.get("name", "") for e in trace["traceEvents"])


def test_vtp_converter(tmp_path, capsys):
    vtp = tmp_path / "t.vtp"
    vtp.write_text(QUAD_VTP)
    obj = str(tmp_path / "t.obj")
    assert vtp_to_obj.main([str(vtp), obj]) == 0
    v, f = _load_obj_py(obj)
    assert v.shape == (4, 3)
    assert f.shape == (2, 3)  # quad fan-triangulated
    assert "4 vertices, 2 triangles" in capsys.readouterr().out
    assert vtp_to_obj.main([str(vtp)]) == 1  # usage
