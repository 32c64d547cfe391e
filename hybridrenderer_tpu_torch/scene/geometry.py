"""Procedural mesh generation, host-side numpy
(hybridrenderer_tpu/scene/geometry.py, unchanged in substance: the
meshes must be identical to the reference's). Mesh layout:
position/normal/tangent/uv.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MeshData:
    """Host-side mesh (SceneCommon.h Mesh + raw vertex data)."""

    positions: np.ndarray  # (V, 3) f32, local space
    normals: np.ndarray    # (V, 3) f32
    tangents: np.ndarray   # (V, 4) f32
    uvs: np.ndarray        # (V, 2) f32
    indices: np.ndarray    # (3F,) i32
    material: int = 0
    name: str = "mesh"

    @property
    def num_vertices(self) -> int:
        return len(self.positions)

    @property
    def num_triangles(self) -> int:
        return len(self.indices) // 3

    def local_aabb(self):
        return self.positions.min(axis=0), self.positions.max(axis=0)


def _mesh(positions, normals, uvs, indices, material=0, tangents=None, name="mesh"):
    positions = np.asarray(positions, np.float32)
    normals = np.asarray(normals, np.float32)
    uvs = np.asarray(uvs, np.float32)
    indices = np.asarray(indices, np.int32).reshape(-1)
    if tangents is None:
        tangents = compute_tangents(positions, normals, uvs, indices)
    return MeshData(positions, normals, np.asarray(tangents, np.float32),
                    uvs, indices, material, name)


def compute_tangents(positions, normals, uvs, indices):
    """MikkTSpace-lite per-vertex tangents from UV derivatives (the job
    Assimp's CalcTangentSpace does for the reference, AssetImporter.cpp:140-147).
    """
    V = len(positions)
    tan = np.zeros((V, 3), np.float64)
    tri = indices.reshape(-1, 3)
    p0, p1, p2 = positions[tri[:, 0]], positions[tri[:, 1]], positions[tri[:, 2]]
    w0, w1, w2 = uvs[tri[:, 0]], uvs[tri[:, 1]], uvs[tri[:, 2]]
    e1, e2 = p1 - p0, p2 - p0
    du1, dv1 = w1[:, 0] - w0[:, 0], w1[:, 1] - w0[:, 1]
    du2, dv2 = w2[:, 0] - w0[:, 0], w2[:, 1] - w0[:, 1]
    r = du1 * dv2 - du2 * dv1
    r = np.where(np.abs(r) < 1e-12, 1.0, r)
    t = ((e1 * dv2[:, None]) - (e2 * dv1[:, None])) / r[:, None]
    for k in range(3):
        np.add.at(tan, tri[:, k], t)
    # Gram-Schmidt against normal
    n = normals.astype(np.float64)
    t_orth = tan - n * np.sum(tan * n, axis=-1, keepdims=True)
    norm = np.linalg.norm(t_orth, axis=-1, keepdims=True)
    fallback = np.tile(np.array([1.0, 0.0, 0.0]), (V, 1))
    t_final = np.where(norm > 1e-8, t_orth / np.maximum(norm, 1e-12), fallback)
    out = np.concatenate([t_final, np.ones((V, 1))], axis=-1)
    return out.astype(np.float32)


def cube(size=1.0, material=0) -> MeshData:
    """Axis-aligned cube with per-face normals/uvs, 24 verts / 12 tris."""
    s = size * 0.5
    faces = [
        # (normal, up, right) per face
        ((0, 0, 1), (0, 1, 0), (1, 0, 0)),
        ((0, 0, -1), (0, 1, 0), (-1, 0, 0)),
        ((1, 0, 0), (0, 1, 0), (0, 0, -1)),
        ((-1, 0, 0), (0, 1, 0), (0, 0, 1)),
        ((0, 1, 0), (0, 0, -1), (1, 0, 0)),
        ((0, -1, 0), (0, 0, 1), (1, 0, 0)),
    ]
    P, N, U, I = [], [], [], []
    for f, (n, up, right) in enumerate(faces):
        n, up, right = map(np.array, (n, up, right))
        base = len(P)
        for (a, b), uv in zip([(-1, -1), (1, -1), (1, 1), (-1, 1)],
                              [(0, 1), (1, 1), (1, 0), (0, 0)]):
            P.append(n * s + right * a * s + up * b * s)
            N.append(n)
            U.append(uv)
        I += [base, base + 1, base + 2, base, base + 2, base + 3]
    return _mesh(P, N, U, I, material, name="cube")


def plane(size=10.0, material=0, y=0.0, uv_scale=1.0) -> MeshData:
    s = size * 0.5
    P = [(-s, y, -s), (s, y, -s), (s, y, s), (-s, y, s)]
    N = [(0, 1, 0)] * 4
    U = [(0, 0), (uv_scale, 0), (uv_scale, uv_scale), (0, uv_scale)]
    I = [0, 2, 1, 0, 3, 2]
    return _mesh(P, N, U, I, material, name="plane")


def quad_facing(normal, center, size, material=0) -> MeshData:
    """A quad centered at `center`, facing along `normal`."""
    n = np.asarray(normal, np.float64)
    n /= np.linalg.norm(n)
    helper = np.array([0, 1, 0]) if abs(n[1]) < 0.9 else np.array([1, 0, 0])
    r = np.cross(helper, n)
    r /= np.linalg.norm(r)
    u = np.cross(n, r)
    c = np.asarray(center, np.float64)
    s = size * 0.5
    P = [c - r * s - u * s, c + r * s - u * s, c + r * s + u * s, c - r * s + u * s]
    N = [n] * 4
    U = [(0, 0), (1, 0), (1, 1), (0, 1)]
    I = [0, 1, 2, 0, 2, 3]
    return _mesh(P, N, U, I, material, name="quad")


def uv_sphere(radius=1.0, rings=16, sectors=32, material=0) -> MeshData:
    P, N, U, I = [], [], [], []
    for r in range(rings + 1):
        theta = np.pi * r / rings
        for s in range(sectors + 1):
            phi = 2 * np.pi * s / sectors
            n = np.array([np.sin(theta) * np.cos(phi), np.cos(theta),
                          np.sin(theta) * np.sin(phi)])
            P.append(n * radius)
            N.append(n)
            U.append((s / sectors, r / rings))
    for r in range(rings):
        for s in range(sectors):
            a = r * (sectors + 1) + s
            b = a + sectors + 1
            # wound so the geometric normal matches the outward attribute
            # normal (CCW seen from outside) — required for back-face cull
            I += [a, a + 1, b, a + 1, b + 1, b]
    return _mesh(P, N, U, I, material, name="sphere")


def merge(meshes: list) -> MeshData:
    """Concatenate meshes that share a material."""
    off, P, N, T, U, I = 0, [], [], [], [], []
    for m in meshes:
        P.append(m.positions)
        N.append(m.normals)
        T.append(m.tangents)
        U.append(m.uvs)
        I.append(m.indices + off)
        off += m.num_vertices
    return MeshData(np.concatenate(P), np.concatenate(N), np.concatenate(T),
                    np.concatenate(U), np.concatenate(I),
                    meshes[0].material, "merged")


def stress_scene_meshes(num_objects=400, seed=0):
    """A Sponza-scale procedural stress set: a floor, columns, and random
    boxes/spheres — used for benchmarks that need ~10^5 triangles without
    shipping external assets. Returns list[(MeshData, transform4x4)]."""
    rng = np.random.default_rng(seed)
    out = []
    out.append((plane(size=60.0, material=0, uv_scale=8.0), np.eye(4, dtype=np.float32)))
    # Peristyle-ish columns
    for i in range(-4, 5):
        for sgn in (-1, 1):
            t = np.eye(4, dtype=np.float32)
            t[:3, 3] = [i * 6.0, 3.0, sgn * 8.0]
            t[0, 0] = t[2, 2] = 0.6
            t[1, 1] = 6.0
            out.append((cube(material=1), t))
    for _ in range(num_objects):
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = [rng.uniform(-25, 25), rng.uniform(0.3, 8.0), rng.uniform(-12, 12)]
        s = rng.uniform(0.2, 1.5)
        t[0, 0] = t[1, 1] = t[2, 2] = s
        mesh = uv_sphere(rings=12, sectors=24, material=2) if rng.random() < 0.5 \
            else cube(material=3)
        out.append((mesh, t))
    return out
