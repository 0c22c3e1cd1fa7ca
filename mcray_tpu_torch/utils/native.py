"""ctypes bridge to the native C++ runtime (native/libmcray_native.so).

The reference's host-side native pieces are Bullet's BVH construction and tinyobj
(SURVEY.md §2.2). Their equivalents live in native/mcray_native.cpp: a
binned-SAH BVH construction and a fast OBJ parser, both emitting flat numpy
arrays. The compute path never calls C++ — only scene compilation does.
Falls back to pure-Python implementations when the shared library has not
been built.

The port's own copy of ``mcray_tpu/utils/native.py``; it loads the same
``native/`` library (which is no part of the JAX package), so on one machine
both packages build the same BVH.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "libmcray_native.so",
)

_native = None
_tried = False


class _Native:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        c_char_p = ctypes.c_char_p
        c_int = ctypes.c_int
        c_fp = ctypes.POINTER(ctypes.c_float)
        c_ip = ctypes.POINTER(ctypes.c_int)

        lib.mcray_load_obj.argtypes = [c_char_p, ctypes.POINTER(c_int), ctypes.POINTER(c_int)]
        lib.mcray_load_obj.restype = ctypes.c_void_p
        lib.mcray_copy_obj.argtypes = [ctypes.c_void_p, c_fp, c_ip]
        lib.mcray_copy_obj.restype = None
        lib.mcray_free.argtypes = [ctypes.c_void_p]
        lib.mcray_free.restype = None

        lib.mcray_build_bvh.argtypes = [c_fp, c_int, c_int, ctypes.POINTER(c_int)]
        lib.mcray_build_bvh.restype = ctypes.c_void_p
        lib.mcray_copy_bvh.argtypes = [ctypes.c_void_p, c_fp, c_ip, c_ip]
        lib.mcray_copy_bvh.restype = None

    def load_obj(self, path: str):
        nv = ctypes.c_int(0)
        nf = ctypes.c_int(0)
        h = self._lib.mcray_load_obj(path.encode(), ctypes.byref(nv), ctypes.byref(nf))
        if not h:
            return None
        verts = np.empty((nv.value, 3), np.float32)
        faces = np.empty((nf.value, 3), np.int32)
        self._lib.mcray_copy_obj(
            h,
            verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        self._lib.mcray_free(h)
        return verts, faces

    def build_bvh(self, tris: np.ndarray, leaf_size: int = 4):
        """tris: (T,3,3) f32 -> (nodes (N,6), meta (N,2), tri_order (T,)).

        Flat depth-first layout: nodes = [min.xyz, max.xyz]; meta for an
        inner node = (right-child index, -1) with left child at node+1; for a
        leaf = (first offset into tri_order, count)."""
        tris = np.ascontiguousarray(tris, np.float32)
        t = tris.shape[0]
        n_nodes = ctypes.c_int(0)
        h = self._lib.mcray_build_bvh(
            tris.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            t,
            leaf_size,
            ctypes.byref(n_nodes),
        )
        if not h:
            return None
        nodes = np.empty((n_nodes.value, 6), np.float32)
        meta = np.empty((n_nodes.value, 2), np.int32)
        order = np.empty((t,), np.int32)
        self._lib.mcray_copy_bvh(
            h,
            nodes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            order.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        self._lib.mcray_free(h)
        return nodes, meta, order


def get_native():
    """Return the loaded native module, or None if unavailable."""
    global _native, _tried
    if not _tried:
        _tried = True
        try:
            if os.path.exists(_LIB_PATH):
                _native = _Native(ctypes.CDLL(_LIB_PATH))
        except OSError:
            _native = None
    return _native
