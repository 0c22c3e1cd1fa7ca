"""VTK PolyData (.vtp) -> Wavefront OBJ converter.

The port's copy of ``mcray_tpu/utils/vtp_to_obj.py`` (numpy and XML only),
writing through the port's own ``scene/obj.py``. Like it, it stands in for
the C++ reference's asset-prep script (utils/vtp_to_obj.py there: Python 2,
a hardcoded Windows path, the vtk package, and it only prints vertices): a
self-contained parser for ASCII and appended-base64 XML .vtp files (the
IRCAD dataset format) with no VTK dependency, which triangulates polys and
writes a complete OBJ.

Usage: python -m mcray_tpu_torch.utils.vtp_to_obj input.vtp output.obj
"""

from __future__ import annotations

import base64
import struct
import sys
import xml.etree.ElementTree as ET

import numpy as np

_DTYPES = {
    "Float32": np.float32,
    "Float64": np.float64,
    "Int32": np.int32,
    "Int64": np.int64,
    "UInt32": np.uint32,
    "UInt64": np.uint64,
    "UInt8": np.uint8,
}


def _read_data_array(el, appended: bytes | None):
    dtype = _DTYPES[el.get("type")]
    fmt = el.get("format", "ascii")
    if fmt == "ascii":
        text = (el.text or "").split()
        return np.asarray(text, dtype=np.float64).astype(dtype) if text else np.zeros(0, dtype)
    if fmt == "binary":
        raw = base64.b64decode("".join((el.text or "").split()))
        # first uint32/uint64 is the byte count header
        header = struct.unpack("<I", raw[:4])[0]
        if header == len(raw) - 8:  # 64-bit header
            raw = raw[8:]
        else:
            raw = raw[4 : 4 + header]
        return np.frombuffer(raw, dtype=dtype)
    if fmt == "appended" and appended is not None:
        off = int(el.get("offset", "0"))
        header = struct.unpack("<I", appended[off : off + 4])[0]
        return np.frombuffer(appended[off + 4 : off + 4 + header], dtype=dtype)
    raise ValueError(f"unsupported DataArray format {fmt}")


def vtp_to_arrays(path: str):
    """Returns (vertices (V,3) f32, faces (F,3) i32)."""
    with open(path, "rb") as f:
        data = f.read()
    appended = None
    marker = data.find(b"<AppendedData")
    if marker >= 0:
        start = data.find(b"_", marker) + 1
        end = data.rfind(b"</AppendedData>")
        appended = base64.b64decode(data[start:end].strip()) if b"base64" in data[marker:start] else data[start:end]
        data = data[:marker] + b"</VTKFile>"
    root = ET.fromstring(data.decode("utf-8", errors="replace"))

    piece = root.find(".//Piece")
    pts_el = piece.find("./Points/DataArray")
    points = _read_data_array(pts_el, appended).astype(np.float32).reshape(-1, 3)

    polys = piece.find("./Polys")
    conn = offs = None
    for arr in polys.findall("DataArray"):
        if arr.get("Name") == "connectivity":
            conn = _read_data_array(arr, appended).astype(np.int64)
        elif arr.get("Name") == "offsets":
            offs = _read_data_array(arr, appended).astype(np.int64)
    faces = []
    start = 0
    for off in offs:
        poly = conn[start:off]
        for k in range(1, len(poly) - 1):  # fan triangulation
            faces.append((poly[0], poly[k], poly[k + 1]))
        start = off
    return points, np.asarray(faces, np.int32).reshape(-1, 3)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__)
        return 1
    from ..scene.obj import save_obj

    verts, faces = vtp_to_arrays(argv[0])
    save_obj(argv[1], verts, faces)
    print(f"{argv[0]}: {len(verts)} vertices, {len(faces)} triangles -> {argv[1]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
