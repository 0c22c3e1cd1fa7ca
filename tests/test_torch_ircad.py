"""The 123,224-triangle ircad_hd scene through the port's cluster paths, and
the Simulator's choice of closest hit.

On the CPU every path runs its kernel's plain version. The listed frame
(the default at this size) must equal the brute frame, and the grouped
frame the listed one: segment validity and
media ids equal, images allclose (rtol 1e-5, atol 1e-6: the same segments
march through the same code, so only a different winner on an exact tie
could move a float). The phantom meshes are generated into ``tmp_path``.
"""

import pytest
import torch

from _torch_port import SPHERE_SCENE
from mcray_tpu_torch.config import small_test_config
from mcray_tpu_torch.models.simulator import Simulator
from mcray_tpu_torch.scene.compile import load_and_compile

IRCAD_HD_SCENE = SPHERE_SCENE.replace("sphere/sphere.scene", "ircad11_hd/santi-liver-hd.scene")


@pytest.fixture(scope="module")
def ircad_hd(tmp_path_factory):
    return load_and_compile(IRCAD_HD_SCENE, asset_dir=str(tmp_path_factory.mktemp("ircad_hd")))


def test_ircad_hd_listed_frame_equals_brute(ircad_hd):
    assert ircad_hd.n_triangles == 123_224
    cfg = small_test_config(transducer_elements=16, samples_per_element=2)
    listed = Simulator(ircad_hd, cfg, device="cpu")
    assert listed.culled_tris[1] == "listed" and listed.intersect_tile_r == 512
    assert listed.culled_tris[0].tile_t == 128
    brute = Simulator(ircad_hd, cfg, device="cpu", use_culled_intersect=False)
    a, b = listed.render_frame(7), brute.render_frame(7)
    assert int(b["segments"]["valid"].sum()) > 50
    for key in ("valid", "media_id"):
        assert torch.equal(a["segments"][key], b["segments"][key]), key
    for key in ("rf_raw", "bmode"):
        torch.testing.assert_close(a[key], b[key], rtol=1e-5, atol=1e-6)
    assert float(a["bmode"].std()) > 0


def test_ircad_hd_grouped_frame_equals_listed(ircad_hd):
    """Grouped mode (K10's plain version, then the residual listed pass) on
    the large scene: the same closest hits as listed, so the same frame."""
    cfg = small_test_config(transducer_elements=16, samples_per_element=2)
    grouped = Simulator(ircad_hd, cfg, device="cpu", intersect_mode="grouped")
    assert grouped.culled_tris[1] == "grouped" and grouped.culled_tris[0].tile_t == 128
    a = grouped.render_frame(7)
    b = Simulator(ircad_hd, cfg, device="cpu").render_frame(7)
    assert int(b["segments"]["valid"].sum()) > 50
    for key in ("valid", "media_id", "to"):
        assert torch.equal(a["segments"][key], b["segments"][key]), key
    for key in ("rf_raw", "bmode"):
        torch.testing.assert_close(a[key], b[key], rtol=1e-5, atol=1e-6)


def test_simulator_picks_the_reference_default():
    pack = load_and_compile(SPHERE_SCENE)  # 2,220 triangles: over the 2,048 threshold
    cfg = small_test_config(transducer_elements=16, samples_per_element=2)
    sim = Simulator(pack, cfg, device="cpu")
    assert sim.culled_tris[1] == "listed" and sim.intersect_tile_r == 512
    for mode in ("culled", "staged"):
        sim = Simulator(pack, cfg, device="cpu", intersect_mode=mode)
        assert sim.culled_tris[1] == mode and sim.culled_tris[0].tile_t == 256
    sim = Simulator(pack, cfg, device="cpu", use_culled_intersect=False)
    assert sim.culled_tris is None and sim.intersect_tile_r == 128
    sim = Simulator(pack, cfg, device="cpu", intersect_mode="grouped")
    assert sim.culled_tris[1] == "grouped" and sim.culled_tris[0].tile_t == 128
    assert sim.intersect_tile_r == 512
    with pytest.raises(ValueError, match="intersect_mode"):
        Simulator(pack, cfg, device="cpu", intersect_mode="lsited")
