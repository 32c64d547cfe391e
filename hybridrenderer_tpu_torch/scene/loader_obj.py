"""Wavefront OBJ (+ MTL) import, host numpy
(hybridrenderer_tpu/scene/loader_obj.py).

Materials map onto the Material schema's PBR slots (map_Kd → colour
texture, map_Ke → emission, bump / map_Bump / norm → normal, map_Pr /
map_Ns → roughness). Polygons are fan-triangulated; normals are made
smooth where the file has none, and tangents come from
geometry.compute_tangents. ``load_obj`` reads the file's numbers and
faces with the native tokenizer (scene/loader_native.py);
``load_obj_python`` with a Python one, the reference the native one is
tested against. The two give the same triangles, in another vertex
order.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from .geometry import MeshData, compute_tangents
from .schema import Material

TexPaths = Dict[int, Dict[str, str]]
_MAP_SLOTS = {"map_Kd": "colour", "map_Ke": "emission", "map_Bump": "normal",
              "bump": "normal", "norm": "normal", "map_Pr": "roughness",
              "map_Ns": "roughness"}


def parse_mtl(path: str) -> Tuple[Dict[str, Material],
                                  Dict[str, Dict[str, str]]]:
    """→ (material by name, its texture file by slot, by name)."""
    mats: Dict[str, Material] = {}
    tex: Dict[str, Dict[str, str]] = {}
    if not os.path.exists(path):
        return mats, tex
    cur = None

    def flush():
        if cur is not None:
            mats[cur["name"]] = Material(
                name=cur["name"],
                colour=tuple(cur.get("Kd", (0.8, 0.8, 0.8))),
                emission=tuple(cur.get("Ke", (0.0, 0.0, 0.0))),
                roughness=cur.get("roughness", 0.5),
                metallic=cur.get("metallic", 0.0),
                opacity=cur.get("d", 1.0),
                # OBJ carries no sidedness: two-sided, for open meshes
                double_sided=True)
            tex[cur["name"]] = dict(cur["tex"])

    with open(path, "r", errors="replace") as f:
        for line in f:
            t = line.split()
            if not t or t[0].startswith("#"):
                continue
            key = t[0]
            if key == "newmtl":
                flush()
                cur = {"name": t[1], "tex": {}}
            elif cur is None:
                continue
            elif key in ("Kd", "Ke"):
                cur[key] = [float(x) for x in t[1:4]]
            elif key == "Ns":  # shininess → roughness
                ns = float(t[1])
                cur["roughness"] = float(np.clip(1.0 - np.sqrt(ns) / 31.62,
                                                 0.03, 1.0))
            elif key == "Pm":
                cur["metallic"] = float(t[1])
            elif key == "Pr":
                cur["roughness"] = float(t[1])
            elif key == "d":
                cur["d"] = float(t[1])
            elif key == "Tr":
                cur["d"] = 1.0 - float(t[1])
            elif key in _MAP_SLOTS:
                cur["tex"][_MAP_SLOTS[key]] = t[-1]
    flush()
    return mats, tex


def _finish_mesh(vp, vn, vt, indices, mat_idx, name) -> MeshData:
    """Smooth normals where the file has none, else unit ones; tangents."""
    if np.allclose(vn, 0.0):
        vn = smooth_normals(vp, indices)
    else:
        lens = np.linalg.norm(vn, axis=-1, keepdims=True)
        vn = vn / np.maximum(lens, 1e-8)
    tangents = compute_tangents(vp, vn, vt, indices)
    return MeshData(vp, vn, tangents, vt, indices, material=mat_idx,
                    name=name)


def _material(name, mtl, mtl_tex, base, materials, tex_paths, default):
    """Append the material ``name`` (``default`` when the MTL lacks it)
    and its texture paths → its index."""
    idx = len(materials)
    materials.append(mtl.get(name, default))
    tp = mtl_tex.get(name)
    if tp:
        tex_paths[idx] = {k: os.path.join(base, v) for k, v in tp.items()}
    return idx


def load_obj(path: str) -> Tuple[List[MeshData], List[Material], TexPaths]:
    """An OBJ → (one mesh per material, materials, texture file by slot
    by material index). Texture decoding and stacking is
    scene/loader.py's."""
    from .loader_native import parse_obj_native

    return _assemble_from_native(path, parse_obj_native(path))


def load_obj_python(path: str) -> Tuple[List[MeshData], List[Material],
                                        TexPaths]:
    """``load_obj`` through the Python tokenizer: one vertex per distinct
    v/vt/vn token of a mesh, in first-use order."""
    positions: List = []
    texcoords: List = []
    normals: List = []
    mtl: Dict[str, Material] = {}
    mtl_tex: Dict[str, Dict[str, str]] = {}
    faces_by_mat: Dict[str, List] = {}
    cur_mat = ""
    base = os.path.dirname(path)
    with open(path, "r", errors="replace") as f:
        for line in f:
            t = line.split()
            if not t or t[0].startswith("#"):
                continue
            key = t[0]
            if key == "v":
                positions.append([float(x) for x in t[1:4]])
            elif key == "vt":
                texcoords.append([float(t[1]),
                                  float(t[2]) if len(t) > 2 else 0.0])
            elif key == "vn":
                normals.append([float(x) for x in t[1:4]])
            elif key == "mtllib":
                m, mt = parse_mtl(os.path.join(base, t[1]))
                mtl.update(m)
                mtl_tex.update(mt)
            elif key == "usemtl":
                cur_mat = t[1]
            elif key == "f":
                verts = t[1:]
                tri_list = faces_by_mat.setdefault(cur_mat, [])
                for k in range(1, len(verts) - 1):
                    tri_list.append((verts[0], verts[k], verts[k + 1]))

    P = np.asarray(positions, np.float32)
    T = np.asarray(texcoords, np.float32) if texcoords else \
        np.zeros((0, 2), np.float32)
    N = np.asarray(normals, np.float32) if normals else \
        np.zeros((0, 3), np.float32)

    def idx(token: str, count: int) -> int:
        i = int(token)
        return i - 1 if i > 0 else count + i

    materials: List[Material] = []
    tex_paths: TexPaths = {}
    meshes: List[MeshData] = []
    for mat_name, faces in faces_by_mat.items():
        mat_idx = _material(mat_name, mtl, mtl_tex, base, materials,
                            tex_paths, Material(name=mat_name or "default",
                                                double_sided=True))
        cache: Dict[str, int] = {}
        vp, vt, vn, indices = [], [], [], []
        for tri in faces:
            for token in tri:
                if token not in cache:
                    parts = token.split("/")
                    pi = idx(parts[0], len(P))
                    ti = idx(parts[1], len(T)) \
                        if len(parts) > 1 and parts[1] else -1
                    ni = idx(parts[2], len(N)) \
                        if len(parts) > 2 and parts[2] else -1
                    cache[token] = len(vp)
                    vp.append(P[pi])
                    vt.append(T[ti] if ti >= 0 else np.zeros(2, np.float32))
                    vn.append(N[ni] if ni >= 0 else np.zeros(3, np.float32))
                indices.append(cache[token])
        meshes.append(_finish_mesh(
            np.asarray(vp, np.float32), np.asarray(vn, np.float32),
            np.asarray(vt, np.float32), np.asarray(indices, np.int32),
            mat_idx, mat_name or "obj"))
    return meshes, materials, tex_paths


def _assemble_from_native(path: str, parsed) -> Tuple[List[MeshData],
                                                      List[Material],
                                                      TexPaths]:
    """The meshes from the native tokenizer's flat arrays: one vertex
    per distinct v / vt / vn triple, in sorted order."""
    P, T, N, tri, tri_mat, mat_names, mtllib = parsed
    base = os.path.dirname(path)
    mtl, mtl_tex = parse_mtl(os.path.join(base, mtllib)) if mtllib \
        else ({}, {})
    materials: List[Material] = []
    tex_paths: TexPaths = {}
    meshes: List[MeshData] = []
    if len(tri) == 0:
        return meshes, [Material(double_sided=True)], tex_paths
    for mat_id in np.unique(tri_mat):
        name = mat_names[mat_id] if 0 <= mat_id < len(mat_names) \
            else "default"
        mat_idx = _material(name, mtl, mtl_tex, base, materials, tex_paths,
                            Material(name=name, double_sided=True))
        corners = tri[tri_mat == mat_id].reshape(-1, 3)   # (3F, 3) v/vt/vn
        uniq, inverse = np.unique(corners, axis=0, return_inverse=True)
        vp = P[np.clip(uniq[:, 0], 0, len(P) - 1)]
        vt = np.where(uniq[:, 1:2] >= 0,
                      T[np.clip(uniq[:, 1], 0, max(len(T) - 1, 0))]
                      if len(T) else np.zeros((len(uniq), 2), np.float32),
                      0.0).astype(np.float32)
        vn = np.where(uniq[:, 2:3] >= 0,
                      N[np.clip(uniq[:, 2], 0, max(len(N) - 1, 0))]
                      if len(N) else np.zeros((len(uniq), 3), np.float32),
                      0.0).astype(np.float32)
        meshes.append(_finish_mesh(vp, vn, vt,
                                   inverse.reshape(-1).astype(np.int32),
                                   mat_idx, name))
    return meshes, materials, tex_paths


def smooth_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals."""
    tri = indices.reshape(-1, 3)
    p0, p1, p2 = (positions[tri[:, k]] for k in range(3))
    fn = np.cross(p1 - p0, p2 - p0)  # area-weighted
    out = np.zeros_like(positions)
    for k in range(3):
        np.add.at(out, tri[:, k], fn)
    lens = np.linalg.norm(out, axis=-1, keepdims=True)
    return (out / np.maximum(lens, 1e-12)).astype(np.float32)
