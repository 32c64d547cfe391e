"""The benchmark's own copy of the procedural stress scene
(hybridrenderer_tpu_torch/scene/geometry.py ``stress_scene_meshes`` and
scene/scene.py ``stress_scene``): a 60 x 60 floor, 18 columns and
``num_objects`` boxes and spheres, their four materials, the optional
procedural colour textures and the sun. Frozen here, so that an edit of
the port's generator cannot change the workload.

One change from the source: the source draws each object's kind from
its generator (``rng.random() < 0.5``), so the triangle count moves with
the seed. Here the configuration fixes how many of the objects are
spheres (``spheres``: the source's count at its seed 0) and the seed
orders the kinds, so every seed renders the same number of triangles;
positions and scales are drawn from the seed as the source draws them.

``generate`` returns plain numpy arrays; ``build_host_scene`` hands the
same arrays to a package's host ``Scene`` (the port's, or the
reference's copy), each through its own classes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

INVALID_ID = -1


@dataclasses.dataclass
class Mesh:
    positions: np.ndarray  # (V, 3) f32
    normals: np.ndarray    # (V, 3) f32
    tangents: np.ndarray   # (V, 4) f32
    uvs: np.ndarray        # (V, 2) f32
    indices: np.ndarray    # (3F,) i32
    material: int
    name: str


@dataclasses.dataclass
class SceneDesc:
    materials: list        # dicts of Material fields
    meshes: list           # Mesh, one per entity
    transforms: np.ndarray  # (E, 4, 4) f32, entity e draws mesh e
    kinds: list            # each entity's kind: floor, column, sphere, box
    textures: tuple        # (data (N, S, S, 4) f32, sizes (N, 2) i32) or None
    sun: dict

    @property
    def num_triangles(self) -> int:
        return sum(len(m.indices) // 3 for m in self.meshes)


def compute_tangents(positions, normals, uvs, indices):
    """geometry.compute_tangents: per-vertex tangents from UV
    derivatives, Gram-Schmidt against the normal."""
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
    n = normals.astype(np.float64)
    t_orth = tan - n * np.sum(tan * n, axis=-1, keepdims=True)
    norm = np.linalg.norm(t_orth, axis=-1, keepdims=True)
    fallback = np.tile(np.array([1.0, 0.0, 0.0]), (V, 1))
    t_final = np.where(norm > 1e-8, t_orth / np.maximum(norm, 1e-12),
                       fallback)
    return np.concatenate([t_final, np.ones((V, 1))], axis=-1).astype(
        np.float32)


def _mesh(P, N, U, I, material, name) -> Mesh:
    P = np.asarray(P, np.float32)
    N = np.asarray(N, np.float32)
    U = np.asarray(U, np.float32)
    I = np.asarray(I, np.int32).reshape(-1)
    return Mesh(P, N, compute_tangents(P, N, U, I), U, I, material, name)


def cube(material) -> Mesh:
    """geometry.cube(size=1): 24 vertices, 12 triangles."""
    s = 0.5
    faces = [((0, 0, 1), (0, 1, 0), (1, 0, 0)),
             ((0, 0, -1), (0, 1, 0), (-1, 0, 0)),
             ((1, 0, 0), (0, 1, 0), (0, 0, -1)),
             ((-1, 0, 0), (0, 1, 0), (0, 0, 1)),
             ((0, 1, 0), (0, 0, -1), (1, 0, 0)),
             ((0, -1, 0), (0, 0, 1), (1, 0, 0))]
    P, N, U, I = [], [], [], []
    for n, up, right in faces:
        n, up, right = map(np.array, (n, up, right))
        base = len(P)
        for (a, b), uv in zip([(-1, -1), (1, -1), (1, 1), (-1, 1)],
                              [(0, 1), (1, 1), (1, 0), (0, 0)]):
            P.append(n * s + right * a * s + up * b * s)
            N.append(n)
            U.append(uv)
        I += [base, base + 1, base + 2, base, base + 2, base + 3]
    return _mesh(P, N, U, I, material, "cube")


def plane(size, material, uv_scale) -> Mesh:
    """geometry.plane at y = 0."""
    s = size * 0.5
    P = [(-s, 0.0, -s), (s, 0.0, -s), (s, 0.0, s), (-s, 0.0, s)]
    U = [(0, 0), (uv_scale, 0), (uv_scale, uv_scale), (0, uv_scale)]
    return _mesh(P, [(0, 1, 0)] * 4, U, [0, 2, 1, 0, 3, 2], material,
                 "plane")


def uv_sphere(rings, sectors, material) -> Mesh:
    """geometry.uv_sphere(radius=1)."""
    P, N, U, I = [], [], [], []
    for r in range(rings + 1):
        theta = np.pi * r / rings
        for s in range(sectors + 1):
            phi = 2 * np.pi * s / sectors
            n = np.array([np.sin(theta) * np.cos(phi), np.cos(theta),
                          np.sin(theta) * np.sin(phi)])
            P.append(n)
            N.append(n)
            U.append((s / sectors, r / rings))
    for r in range(rings):
        for s in range(sectors):
            a = r * (sectors + 1) + s
            b = a + sectors + 1
            I += [a, a + 1, b, a + 1, b + 1, b]
    return _mesh(P, N, U, I, material, "sphere")


def _textures(n):
    """stress_scene(textured=True)'s four procedural n x n colour
    textures."""
    yy, xx = np.mgrid[0:n, 0:n] / (n - 1.0)
    pats = [((yy * 8).astype(int) + (xx * 8).astype(int)) % 2 * 0.6 + 0.3,
            (np.sin(yy * 40) * 0.5 + 0.5) * 0.7 + 0.2,
            (np.hypot(xx - 0.5, yy - 0.5) * 2.0) % 1.0,
            ((yy * 16).astype(int) % 2) * 0.5 + 0.4]
    data = np.ones((4, n, n, 4), np.float32)
    for i, p in enumerate(pats):
        data[i, ..., 0] = p
        data[i, ..., 1] = p * 0.8 + 0.1
        data[i, ..., 2] = 1.0 - p * 0.5
    return data, np.full((4, 2), n, np.int32)


def generate(scene_cfg: dict, seed: int) -> SceneDesc:
    """The stress scene of ``scene_cfg`` (num_objects, spheres, textured,
    tex_size) drawn from ``seed``."""
    n_obj, n_sph = int(scene_cfg["num_objects"]), int(scene_cfg["spheres"])
    if not 0 <= n_sph <= n_obj:
        raise ValueError(f"spheres must lie in [0, {n_obj}], got {n_sph}")
    textured = bool(scene_cfg.get("textured", False))
    tex = (lambda i: i) if textured else (lambda i: INVALID_ID)
    materials = [
        dict(name="floor", colour=(0.55, 0.5, 0.45), roughness=0.8,
             colour_texture=tex(0)),
        dict(name="column", colour=(0.7, 0.68, 0.6), roughness=0.6,
             colour_texture=tex(1)),
        dict(name="sphere", colour=(0.3, 0.4, 0.7), roughness=0.3,
             metallic=0.4, colour_texture=tex(2)),
        dict(name="box", colour=(0.7, 0.3, 0.2), roughness=0.5,
             colour_texture=tex(3))]
    rng = np.random.default_rng(seed)
    meshes, transforms, kinds = [plane(60.0, 0, 8.0)], [np.eye(4)], ["floor"]
    column = cube(1)
    for i in range(-4, 5):
        for sgn in (-1, 1):
            t = np.eye(4)
            t[:3, 3] = [i * 6.0, 3.0, sgn * 8.0]
            t[0, 0] = t[2, 2] = 0.6
            t[1, 1] = 6.0
            meshes.append(column)
            transforms.append(t)
            kinds.append("column")
    sphere, box = uv_sphere(12, 24, 2), cube(3)
    is_sphere = rng.permutation(np.arange(n_obj) < n_sph)
    for k in range(n_obj):
        t = np.eye(4)
        t[:3, 3] = [rng.uniform(-25, 25), rng.uniform(0.3, 8.0),
                    rng.uniform(-12, 12)]
        t[0, 0] = t[1, 1] = t[2, 2] = rng.uniform(0.2, 1.5)
        meshes.append(sphere if is_sphere[k] else box)
        transforms.append(t)
        kinds.append("sphere" if is_sphere[k] else "box")
    return SceneDesc(
        materials=materials, meshes=meshes,
        transforms=np.stack(transforms).astype(np.float32), kinds=kinds,
        textures=_textures(int(scene_cfg["tex_size"])) if textured else None,
        sun=dict(direction=(-0.4, -1.0, -0.3), intensity=3.0))


def build_host_scene(desc: SceneDesc, scene_cls, material_cls, mesh_cls,
                     texture_cls, to_tensor):
    """The host Scene of a package (its Scene, Material, MeshData and
    TextureStack classes; ``to_tensor`` numpy → tensor) over the
    description's arrays. Each entity gets a mesh of its own, as the
    source's ``add_model`` gives it; meshes of one kind share arrays."""
    sc = scene_cls("stress")
    for m in desc.materials:
        sc.add_material(material_cls(**m))
    for mesh, t in zip(desc.meshes, desc.transforms):
        sc.add_entity(sc.add_mesh(mesh_cls(
            mesh.positions, mesh.normals, mesh.tangents, mesh.uvs,
            mesh.indices, mesh.material, mesh.name)), t.copy(), name="model")
    if desc.textures is not None:
        data, sizes = desc.textures
        sc.textures = texture_cls(data=to_tensor(data),
                                  sizes=to_tensor(sizes))
    sc.set_sun(desc.sun["direction"], intensity=desc.sun["intensity"])
    return sc
