"""The port's config validation and its ``render`` command, on the CPU."""

import json

import pytest

from _torch_port import SPHERE_SCENE
from mcray_tpu_torch import cli
from mcray_tpu_torch.config import SimConfig, validate


@pytest.mark.parametrize("field", ["scatter_rng", "texture_mode", "envelope_mode", "probe_type"])
def test_validate_rejects_unknown_modes(field):
    assert validate(SimConfig()) == SimConfig()
    with pytest.raises(ValueError, match=field):
        validate(SimConfig(**{field: "typo"}))


def test_render_command_writes_the_frame(tmp_path, capsys):
    out = tmp_path / "frame.png"
    argv = [SPHERE_SCENE, "--elements", "16", "--samples", "2", "--frames", "2", "--seed", "3",
            "--device", "cpu", "--out", str(out)]
    assert cli.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("scene: 2220 triangles")
    assert lines[1].startswith("frame 0:") and lines[2].startswith("frame 1:")
    summary = json.loads(lines[-1])
    assert summary["device"] == "cpu" and summary["rays_per_s"] > 0
    # PNG with pillow, else the PGM fallback of image_io.save_png
    assert out.exists() or (tmp_path / "frame.png.pgm").exists()


@pytest.mark.parametrize("mode", ["culled", "grouped"])
def test_render_command_intersect_mode(tmp_path, capsys, mode):
    argv = [SPHERE_SCENE, "--elements", "16", "--samples", "2", "--intersect-mode", mode,
            "--intersect-tile-r", "256", "--device", "cpu", "--out", str(tmp_path / "frame.png")]
    assert cli.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert f"intersect {mode}" in lines[0] and lines[1].startswith("frame 0:")
    # PNG with pillow, else the PGM fallback of image_io.save_png
    assert (tmp_path / "frame.png").exists() or (tmp_path / "frame.png.pgm").exists()


def test_grouped_residual_packets_must_be_chunk_multiples(tmp_path):
    argv = [SPHERE_SCENE, "--elements", "16", "--samples", "2", "--intersect-mode", "grouped",
            "--intersect-tile-r", "100", "--device", "cpu", "--out", str(tmp_path / "frame.png")]
    with pytest.raises(ValueError, match="multiple of 128"):
        cli.main(argv)
