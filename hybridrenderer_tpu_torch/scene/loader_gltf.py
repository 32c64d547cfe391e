"""glTF 2.0 import, .gltf (JSON + .bin) and .glb, host numpy
(hybridrenderer_tpu/scene/loader_gltf.py).

Accessors and buffer views become numpy arrays; the node hierarchy is
flattened into world transforms; PBR metallic-roughness materials map
onto the Material schema's texture slots (baseColorTexture → colour,
metallicRoughnessTexture → roughness (g roughness, b metallic),
normalTexture, emissiveTexture). An image is a file beside the scene or
embedded (a buffer view or a data URI); an embedded one is handed on as
its encoded bytes, which scene/loader.py decodes. The reference skips
embedded images, so a material that binds one renders untextured there.
"""
from __future__ import annotations

import base64
import json
import os
import struct
from typing import Dict, List, Tuple, Union
from urllib.parse import unquote

import numpy as np

from .geometry import MeshData, compute_tangents
from .loader_obj import smooth_normals
from .schema import Material

_COMPONENT_DTYPE = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNT = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
               "MAT4": 16}


def _load_glb(path: str):
    with open(path, "rb") as f:
        magic, version, _length = struct.unpack("<III", f.read(12))
        assert magic == 0x46546C67, "not a GLB file"
        gltf = None
        buffers = []
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            clen, ctype = struct.unpack("<II", head)
            data = f.read(clen)
            if ctype == 0x4E4F534A:  # JSON
                gltf = json.loads(data.decode("utf-8"))
            elif ctype == 0x004E4942:  # BIN
                buffers.append(data)
        return gltf, buffers


def _read_buffers(gltf: dict, base_dir: str, glb_buffers):
    out = []
    for i, buf in enumerate(gltf.get("buffers", [])):
        uri = buf.get("uri")
        if uri is None:
            out.append(glb_buffers[i])
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, unquote(uri)), "rb") as f:
                out.append(f.read())
    return out


def _accessor(gltf, buffers, idx) -> np.ndarray:
    acc = gltf["accessors"][idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPE[acc["componentType"]]
    ncomp = _TYPE_COUNT[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride")
    data = buffers[view["buffer"]]
    itemsize = np.dtype(dtype).itemsize * ncomp
    if stride and stride != itemsize:
        raw = np.frombuffer(data, np.uint8,
                            count=stride * (count - 1) + itemsize,
                            offset=offset)
        rows = np.lib.stride_tricks.as_strided(
            raw, shape=(count, itemsize), strides=(stride, 1))
        arr = rows.reshape(-1).view(dtype).reshape(count, ncomp)
    else:
        arr = np.frombuffer(data, dtype, count=count * ncomp,
                            offset=offset).reshape(count, ncomp)
    if acc.get("normalized") and dtype in (np.uint8, np.uint16):
        arr = arr.astype(np.float32) / np.iinfo(dtype).max
    return np.array(arr)


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "translation" in node or "rotation" in node or "scale" in node:
        t = np.asarray(node.get("translation", [0, 0, 0]), np.float32)
        q = np.asarray(node.get("rotation", [0, 0, 0, 1]), np.float32)  # xyzw
        s = np.asarray(node.get("scale", [1, 1, 1]), np.float32)
        x, y, z, w = q
        rot = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ], np.float32)
        m[:3, :3] = rot * s[None, :]
        m[:3, 3] = t
    return m


def load_gltf(path: str) -> Tuple[List[Tuple[MeshData, np.ndarray]],
                                  List[Material],
                                  Dict[int, Dict[str, Union[str, bytes]]]]:
    """→ ([(mesh, world transform)], materials, the image of each bound
    texture slot by material index: a path, or an embedded image's
    bytes)."""
    base_dir = os.path.dirname(path)
    glb_buffers = []
    if path.lower().endswith(".glb"):
        gltf, glb_buffers = _load_glb(path)
    else:
        with open(path, "r") as f:
            gltf = json.load(f)
    buffers = _read_buffers(gltf, base_dir, glb_buffers)

    # materials
    materials: List[Material] = []
    tex_paths: Dict[int, Dict[str, Union[str, bytes]]] = {}

    def image_path(tex_index):
        """An image file's path, or an embedded image's bytes."""
        img = gltf["images"][gltf["textures"][tex_index]["source"]]
        uri = img.get("uri")
        if uri is None:
            view = gltf["bufferViews"][img["bufferView"]]
            start = view.get("byteOffset", 0)
            return bytes(buffers[view["buffer"]][
                start:start + view["byteLength"]])
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        return os.path.join(base_dir, unquote(uri))

    for gm in gltf.get("materials", [{}]):
        pbr = gm.get("pbrMetallicRoughness", {})
        bc = pbr.get("baseColorFactor", [1, 1, 1, 1])
        mat = Material(
            name=gm.get("name", f"mat{len(materials)}"),
            colour=tuple(bc[:3]),
            opacity=float(bc[3]),
            roughness=float(pbr.get("roughnessFactor", 1.0)),
            metallic=float(pbr.get("metallicFactor", 1.0)),
            emission=tuple(gm.get("emissiveFactor", [0, 0, 0])),
            # MASK → alpha-tested cut-out
            alpha_mode=1 if gm.get("alphaMode", "OPAQUE") == "MASK" else 0,
            alpha_cutoff=float(gm.get("alphaCutoff", 0.5)),
            # doubleSided (default false) drives back-face culling
            double_sided=bool(gm.get("doubleSided", False)),
        )
        idx = len(materials)
        materials.append(mat)
        tp = {}
        if "baseColorTexture" in pbr:
            tp["colour"] = image_path(pbr["baseColorTexture"]["index"])
        if "metallicRoughnessTexture" in pbr:
            tp["roughness"] = image_path(pbr["metallicRoughnessTexture"]["index"])
        if "normalTexture" in gm:
            tp["normal"] = image_path(gm["normalTexture"]["index"])
        if "emissiveTexture" in gm:
            tp["emission"] = image_path(gm["emissiveTexture"]["index"])
        if tp:
            tex_paths[idx] = tp
    if not materials:
        materials = [Material()]

    # meshes per primitive
    prim_cache: Dict[Tuple[int, int], MeshData] = {}

    def build_prim(mesh_idx: int, prim_idx: int) -> MeshData:
        key = (mesh_idx, prim_idx)
        if key in prim_cache:
            return prim_cache[key]
        prim = gltf["meshes"][mesh_idx]["primitives"][prim_idx]
        attrs = prim["attributes"]
        pos = _accessor(gltf, buffers, attrs["POSITION"]).astype(np.float32)
        n = pos.shape[0]
        nrm = (_accessor(gltf, buffers, attrs["NORMAL"]).astype(np.float32)
               if "NORMAL" in attrs else None)
        uv = (_accessor(gltf, buffers, attrs["TEXCOORD_0"]).astype(np.float32)
              if "TEXCOORD_0" in attrs else np.zeros((n, 2), np.float32))
        tan = (_accessor(gltf, buffers, attrs["TANGENT"]).astype(np.float32)
               if "TANGENT" in attrs else None)
        if "indices" in prim:
            idx = _accessor(gltf, buffers, prim["indices"]).reshape(-1).astype(np.int32)
        else:
            idx = np.arange(n, dtype=np.int32)
        if nrm is None:
            nrm = smooth_normals(pos, idx)
        if tan is None:
            tan = compute_tangents(pos, nrm, uv, idx)
        m = MeshData(pos, nrm, tan, uv, idx,
                     material=prim.get("material", 0),
                     name=gltf["meshes"][mesh_idx].get("name", "gltf"))
        prim_cache[key] = m
        return m

    out: List[Tuple[MeshData, np.ndarray]] = []
    scene_idx = gltf.get("scene", 0)
    roots = gltf["scenes"][scene_idx]["nodes"] if "scenes" in gltf else \
        list(range(len(gltf.get("nodes", []))))

    def walk(node_idx: int, parent: np.ndarray):
        node = gltf["nodes"][node_idx]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            for pi in range(len(gltf["meshes"][node["mesh"]]["primitives"])):
                out.append((build_prim(node["mesh"], pi), world.copy()))
        for child in node.get("children", []):
            walk(child, world)

    for r in roots:
        walk(r, np.eye(4, dtype=np.float32))
    return out, materials, tex_paths
