"""ctypes bridge to the native OBJ tokenizer, native/obj_loader.cpp
(hybridrenderer_tpu/scene/loader_native.py): the C++ reads the file's
numbers and faces, Python assembles the meshes (scene/loader_obj.py).
The library is built with g++ into build/ at first use (native.py); a
failed build raises."""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from .. import native


class _ObjResult(ctypes.Structure):
    _fields_ = [
        ("positions", ctypes.POINTER(ctypes.c_float)),
        ("texcoords", ctypes.POINTER(ctypes.c_float)),
        ("normals", ctypes.POINTER(ctypes.c_float)),
        ("tri_indices", ctypes.POINTER(ctypes.c_int)),
        ("tri_material", ctypes.POINTER(ctypes.c_int)),
        ("material_names", ctypes.c_char_p),
        ("mtllib", ctypes.c_char_p),
        ("n_positions", ctypes.c_longlong),
        ("n_texcoords", ctypes.c_longlong),
        ("n_normals", ctypes.c_longlong),
        ("n_triangles", ctypes.c_longlong),
    ]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = native.obj_library()
    lib.parse_obj.argtypes = [ctypes.c_char_p, ctypes.POINTER(_ObjResult)]
    lib.parse_obj.restype = ctypes.c_int
    lib.obj_free.argtypes = [ctypes.POINTER(_ObjResult)]
    lib.obj_free.restype = None
    return lib


def parse_obj_native(path: str):
    """→ (positions (P, 3), texcoords (T, 2), normals (N, 3), tri_indices
    (F, 3, 3) i32 of v / vt / vn, -1 where absent, tri_material (F,),
    material names [str], mtllib str). Raises where the file cannot be
    parsed."""
    lib = _library()
    res = _ObjResult()
    rc = lib.parse_obj(path.encode(), ctypes.byref(res))
    if rc != 0:
        raise ValueError(f"native OBJ tokenizer failed ({rc}) on {path}")
    try:
        def arr(ptr, n, w, dt):
            if n == 0:
                return np.zeros((0, w), dt)
            flat = np.ctypeslib.as_array(ptr, shape=(int(n) * w,))
            return flat.astype(dt, copy=True).reshape(int(n), w)

        positions = arr(res.positions, res.n_positions, 3, np.float32)
        texcoords = arr(res.texcoords, res.n_texcoords, 2, np.float32)
        normals = arr(res.normals, res.n_normals, 3, np.float32)
        tri = arr(res.tri_indices, res.n_triangles * 3, 3, np.int32)
        tri = tri.reshape(int(res.n_triangles), 3, 3)
        tri_mat = arr(res.tri_material, res.n_triangles, 1, np.int32)[:, 0]
        names = (res.material_names or b"").decode()
        mat_names = names.split("\n") if names else []
        mtllib = (res.mtllib or b"").decode()
        return positions, texcoords, normals, tri, tri_mat, mat_names, mtllib
    finally:
        lib.obj_free(ctypes.byref(res))
