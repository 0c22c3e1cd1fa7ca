"""The port's ``serve`` and ``sweep`` commands and ``render``'s flags, on the CPU.

``serve`` keeps the reference's protocol (``mcray_tpu/cli.py:181-263``): a
ready line after a warm frame, one frame line per request, an error line for
a malformed request without ending the stream, blank lines skipped, the
seed defaulting to the request's index; a served PNG equals ``save_png`` of
``render_frame`` at the same request, byte for byte. ``sweep`` writes one
PNG per pose step, equal likewise. Each ``render`` flag reaches the config
(or, for ``--bvh``, the closest hit), ``--save-rf`` writes the npz of
``rf_raw``, ``rf_env`` and ``bmode``, ``--dump-column`` prints one line per
RF row, and ``--scatter-rng``'s help names ``bitsum`` as the default (the
reference's help says ``boxmuller``, which is not its default). Frames run
at 32 elements x 1 path; the flag-to-config test renders nothing.
"""

from __future__ import annotations

import io
import json

import numpy as np
import pytest

from _torch_port import SPHERE_SCENE
from mcray_tpu_torch import cli
from mcray_tpu_torch.config import SimConfig
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.scene.compile import load_and_compile
from mcray_tpu_torch.utils.image_io import save_png

SMALL = ["--elements", "32", "--samples", "1", "--device", "cpu"]


def _png(path) -> bytes:
    """The bytes ``save_png`` wrote (a PNG with pillow, else its PGM fallback)."""
    for p in (path, f"{path}.pgm"):
        try:
            with open(p, "rb") as f:
                return f.read()
        except FileNotFoundError:
            continue
    raise FileNotFoundError(path)


@pytest.fixture(scope="module")
def small_sim():
    return Simulator(load_and_compile(SPHERE_SCENE),
                     SimConfig(transducer_elements=32, samples_per_element=1), device="cpu")


def test_serve_protocol(tmp_path, monkeypatch, capsys, small_sim):
    requests = [
        json.dumps({"seed": 4, "position": [-13.5, 0.1, 0.0]}),
        "",
        json.dumps({"angles": [0.0, 0.0, 6.0], "out": str(tmp_path / "turned.png")}),
        json.dumps({"position": [1.0, 2.0]}),  # two coordinates: a bad request
        json.dumps({}),
    ]
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(requests) + "\n"))
    prefix = str(tmp_path / "serve")
    assert cli.main(["serve", SPHERE_SCENE, *SMALL, "--out-prefix", prefix]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]

    assert lines[0] == {"ready": True, "triangles": 2220}
    frames = [x for x in lines[1:] if "frame" in x]
    errors = [x for x in lines[1:] if "error" in x]
    assert len(lines) == 5 and len(frames) == 3 and len(errors) == 1
    assert errors[0]["error"].startswith("bad request: ")
    assert [f["frame"] for f in frames] == [0, 1, 2]
    assert [f["out"] for f in frames] == [f"{prefix}_0000.png", str(tmp_path / "turned.png"),
                                          f"{prefix}_0002.png"]
    assert all(f["ms"] > 0 for f in frames)
    # each served PNG is save_png of render_frame at its request; the seed of
    # a request without one is its index among the served frames
    pos0, ang0 = small_sim.position.numpy(), small_sim.angles.numpy()
    wants = [(4, [-13.5, 0.1, 0.0], ang0), (1, pos0, [0.0, 0.0, 6.0]), (2, pos0, ang0)]
    for frame, (seed, pos, ang) in zip(frames, wants):
        want = str(tmp_path / f"want_{frame['frame']}.png")
        save_png(want, small_sim.render_frame(seed, position=pos, angles=ang)["bmode"].numpy())
        assert _png(frame["out"]) == _png(want)


def test_sweep_writes_a_frame_per_pose(tmp_path, capsys, small_sim):
    prefix = str(tmp_path / "sweep")
    argv = ["sweep", SPHERE_SCENE, *SMALL, "--frames", "2", "--delta-pos", "0", "0.1", "0",
            "--delta-angles", "0", "0", "2", "--seed", "7", "--out-prefix", prefix]
    assert cli.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    assert lines[0].startswith("frame 0: pose [-13.5, 0.0, 0.0]")
    assert lines[1].startswith("frame 1: pose [-13.5, 0.1") and lines[1].endswith(
        f"-> {prefix}_001.png")
    out = small_sim.render_frame(8, position=small_sim.position.numpy() + [0.0, 0.1, 0.0],
                                 angles=small_sim.angles.numpy() + [0.0, 0.0, 2.0])
    save_png(str(tmp_path / "want.png"), out["bmode"].numpy())
    assert _png(f"{prefix}_001.png") == _png(tmp_path / "want.png")
    assert _png(f"{prefix}_000.png") != _png(f"{prefix}_001.png")


class _Captured(Exception):
    pass


@pytest.mark.parametrize("flags,field,value", [
    (["--bug-compat"], "bug_compat_material_transition", True),
    (["--probe", "linear"], "probe_type", "linear"),
    (["--envelope", "hilbert"], "envelope_mode", "hilbert"),
    (["--texture", "table"], "texture_mode", "table"),
    (["--scatter-rng", "boxmuller"], "scatter_rng", "boxmuller"),
    (["--bvh"], "use_bvh", True),
])
def test_render_flag_reaches_the_config(monkeypatch, flags, field, value):
    seen = {}

    def capture(pack, cfg, **kw):
        seen.update(kw, cfg=cfg)
        raise _Captured

    monkeypatch.setattr(cli, "Simulator", capture)
    with pytest.raises(_Captured):
        cli.main([SPHERE_SCENE, "--device", "cpu", *flags])
    got = seen[field] if field == "use_bvh" else getattr(seen["cfg"], field)
    assert got == value
    # the rest stay at their defaults
    defaults = SimConfig()
    for name in ("bug_compat_material_transition", "probe_type", "envelope_mode", "texture_mode",
                 "scatter_rng"):
        if name != field:
            assert getattr(seen["cfg"], name) == getattr(defaults, name)


def test_render_save_rf_dump_column_and_bvh(tmp_path, capsys):
    rf_path = str(tmp_path / "rf.npz")
    argv = [SPHERE_SCENE, *SMALL, "--bvh", "--save-rf", rf_path, "--dump-column", "5",
            "--out", str(tmp_path / "frame.png")]
    assert cli.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "intersect bvh" in lines[0]
    cfg = SimConfig(transducer_elements=32, samples_per_element=1)
    start = lines.index("RF column 5 (row: raw envelope):")
    rows = lines[start + 1:]
    assert len(rows) == cfg.rf_rows and rows[0].startswith("   0: ")
    with np.load(rf_path) as rf:
        assert sorted(rf.files) == ["bmode", "rf_env", "rf_raw"]
        assert rf["rf_raw"].shape == rf["rf_env"].shape == (cfg.rf_rows, cfg.rf_cols)
        assert rf["bmode"].shape == (cfg.bmode_rows, cfg.bmode_cols)
        assert np.abs(rf["rf_raw"]).max() > 0
        raw, env = rf["rf_raw"][:, 5], rf["rf_env"][:, 5]
    # the dump prints the saved column, in the reference's format
    assert rows[7] == f"{7:4d}: {raw[7]: .6e} {env[7]: .6e}"


def test_scatter_rng_help_names_bitsum_the_default(capsys):
    with pytest.raises(SystemExit):
        cli.main([SPHERE_SCENE, "--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "default: bitsum" in text and "default: boxmuller" not in text
    assert SimConfig().scatter_rng == "bitsum"
