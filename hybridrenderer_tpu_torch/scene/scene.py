"""Host-side Scene: entities + meshes → flattened SceneData on a device
(hybridrenderer_tpu/scene/scene.py).

The flatten runs in numpy exactly as the reference's does, so both
packages build identical arrays; ``build(device)`` then moves them onto
the device and joins the per-triangle attribute rows there.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core.types import INVALID_ID
from . import geometry
from .schema import (
    InstanceTable,
    LightTable,
    Material,
    MaterialTable,
    SceneData,
    SunLight,
    TextureStack,
    TriangleSoup,
    VertexArrays,
    build_attr_rows,
    build_raster_rows,
)


@dataclasses.dataclass
class Entity:
    mesh_ids: List[int]
    transform: np.ndarray
    prev_transform: Optional[np.ndarray] = None
    name: str = "entity"


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


class Scene:
    """Mutable host scene; ``build()`` produces the device SceneData."""

    def __init__(self, name: str = "scene"):
        self.name = name
        self.materials: List[Material] = []
        self.meshes: List[geometry.MeshData] = []
        self.entities: List[Entity] = []
        self.sun = SunLight.default()
        self.sky_texture: int = INVALID_ID
        self._blue_noise_seed = 7

    def add_material(self, mat: Material) -> int:
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_mesh(self, mesh: geometry.MeshData) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def add_entity(self, mesh_ids, transform=None, prev_transform=None,
                   name="entity") -> int:
        if isinstance(mesh_ids, int):
            mesh_ids = [mesh_ids]
        t = np.eye(4, dtype=np.float32) if transform is None else \
            np.asarray(transform, np.float32)
        self.entities.append(Entity(list(mesh_ids), t, prev_transform, name))
        return len(self.entities) - 1

    def add_model(self, meshes_with_transforms, name="model"):
        for mesh, t in meshes_with_transforms:
            self.add_entity(self.add_mesh(mesh), t, name=name)

    def set_sun(self, direction, color=(1.0, 1.0, 1.0), intensity=3.0,
                ambient=0.05):
        d = np.asarray(direction, np.float32)
        d = d / np.linalg.norm(d)
        self.sun = SunLight(direction=_t(d),
                            color=torch.tensor(color, dtype=torch.float32),
                            intensity=torch.tensor(np.float32(intensity)),
                            ambient=torch.tensor(np.float32(ambient)))

    def build(self, device="cpu") -> SceneData:
        if not self.materials:
            self.materials = [Material()]

        v_pos, v_nrm, v_tan, v_uv = [], [], [], []
        mesh_voffset, mesh_ioffset, mesh_icount = [], [], []
        all_indices = []
        voff = 0
        for mesh in self.meshes:
            mesh_voffset.append(voff)
            mesh_ioffset.append(sum(len(i) for i in all_indices))
            mesh_icount.append(len(mesh.indices))
            v_pos.append(mesh.positions)
            v_nrm.append(mesh.normals)
            v_tan.append(mesh.tangents)
            v_uv.append(mesh.uvs)
            all_indices.append(mesh.indices.astype(np.int32) + voff)
            voff += mesh.num_vertices

        positions = np.concatenate(v_pos) if v_pos else np.zeros((0, 3), np.float32)
        normals = np.concatenate(v_nrm) if v_nrm else np.zeros((0, 3), np.float32)
        tangents = np.concatenate(v_tan) if v_tan else np.zeros((0, 4), np.float32)
        uvs = np.concatenate(v_uv) if v_uv else np.zeros((0, 2), np.float32)
        indices = np.concatenate(all_indices) if all_indices else np.zeros((0,), np.int32)

        rows = []
        for ent in self.entities:
            prev = ent.prev_transform if ent.prev_transform is not None else ent.transform
            for mid in ent.mesh_ids:
                rows.append((mid, ent.transform, np.asarray(prev, np.float32)))

        n = len(rows)
        tf = np.stack([r[1] for r in rows]) if n else np.zeros((0, 4, 4), np.float32)
        ptf = np.stack([r[2] for r in rows]) if n else np.zeros((0, 4, 4), np.float32)
        inv = np.linalg.inv(tf) if n else tf
        nrm_tf = np.transpose(np.linalg.inv(tf[:, :3, :3]), (0, 2, 1)) if n else \
            np.zeros((0, 3, 3), np.float32)
        nrm4 = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        if n:
            nrm4[:, :3, :3] = nrm_tf

        amin = np.zeros((n, 3), np.float32)
        amax = np.zeros((n, 3), np.float32)
        mat_ids = np.zeros((n,), np.int32)
        voffs = np.zeros((n,), np.int32)
        ioffs = np.zeros((n,), np.int32)
        icnts = np.zeros((n,), np.int32)
        tri_inst, tri_i0, tri_i1, tri_i2 = [], [], [], []
        for i, (mid, t, _) in enumerate(rows):
            mesh = self.meshes[mid]
            lo, hi = mesh.local_aabb()
            corners = np.array(np.meshgrid(*zip(lo, hi))).T.reshape(-1, 3)
            wc = corners @ t[:3, :3].T + t[:3, 3]
            amin[i], amax[i] = wc.min(axis=0), wc.max(axis=0)
            mat_ids[i] = mesh.material
            voffs[i] = mesh_voffset[mid]
            ioffs[i] = mesh_ioffset[mid]
            icnts[i] = mesh_icount[mid]
            gi = mesh.indices.astype(np.int32).reshape(-1, 3) + mesh_voffset[mid]
            tri_i0.append(gi[:, 0])
            tri_i1.append(gi[:, 1])
            tri_i2.append(gi[:, 2])
            tri_inst.append(np.full((len(gi),), i, np.int32))

        instances = InstanceTable(
            transform=_t(tf), inverse_transform=_t(inv.astype(np.float32)),
            normal_transform=_t(nrm4), prev_transform=_t(ptf),
            aabb_min=_t(amin), aabb_max=_t(amax), material=_t(mat_ids),
            vertex_offset=_t(voffs), index_offset=_t(ioffs),
            index_count=_t(icnts),
            selected=torch.zeros((n,), dtype=torch.int32))

        i0 = np.concatenate(tri_i0) if tri_i0 else np.zeros((0,), np.int32)
        i1 = np.concatenate(tri_i1) if tri_i1 else np.zeros((0,), np.int32)
        i2 = np.concatenate(tri_i2) if tri_i2 else np.zeros((0,), np.int32)
        t_inst = np.concatenate(tri_inst) if tri_inst else np.zeros((0,), np.int32)
        pw = _world_positions(positions, tf, rows, mesh_voffset, self.meshes)
        m_alpha = np.array([m.alpha_mode for m in self.materials], np.int32)
        m_ds = np.array([bool(m.double_sided) for m in self.materials])
        tri_mat = mat_ids[t_inst] if len(t_inst) else t_inst
        single = (~m_ds[tri_mat]) & (m_alpha[tri_mat] == 0) \
            if len(t_inst) else np.zeros((0,), bool)
        soup = TriangleSoup(
            v0=_t(pw[i0]), v1=_t(pw[i1]), v2=_t(pw[i2]),
            instance=_t(t_inst), i0=_t(i0), i1=_t(i1), i2=_t(i2),
            single_sided=_t(single))

        lights = build_light_table(self, rows, pw, i0, i1, i2, t_inst)
        vertices = VertexArrays(position=_t(positions), world_position=_t(pw),
                                normal=_t(normals), tangent=_t(tangents),
                                uv=_t(uvs))
        materials = MaterialTable.build(self.materials)
        data = SceneData(
            materials=materials, instances=instances, vertices=vertices,
            indices=_t(indices), triangles=soup, lights=lights,
            textures=TextureStack.empty(), sun=self.sun,
            sky_texture=int(self.sky_texture),
            blue_noise=_t(_generate_blue_noise(64, self._blue_noise_seed)),
            has_alpha_test=any(m.alpha_mode == 1 and m.colour_texture >= 0
                               for m in self.materials),
            has_sky_texture=self.sky_texture != INVALID_ID,
        ).to(device)
        data.attr_rows = build_attr_rows(data.vertices, data.instances,
                                         data.triangles, data.materials)
        data.raster_rows = build_raster_rows(data.vertices, data.instances,
                                             data.triangles, data.materials)
        return data


def _world_positions(positions, tf, rows, mesh_voffset, meshes):
    """World-space copy of each mesh's vertex range, baked with the
    transform of the first instance that references it."""
    pw = positions.copy()
    seen = set()
    for mid, t, _ in rows:
        if mid in seen:
            continue
        seen.add(mid)
        lo = mesh_voffset[mid]
        hi = lo + meshes[mid].num_vertices
        pw[lo:hi] = positions[lo:hi] @ t[:3, :3].T + t[:3, 3]
    return pw


def build_light_table(scene: Scene, rows, pw, i0, i1, i2, t_inst) -> LightTable:
    """Emissive-triangle CDFs: one light per instance whose material
    emits (||emission|| > 1e-3)."""
    lights_inst, cdf_start, cdf_count, env = [], [], [], []
    cdf_all = []
    for inst_id, (mid, _, _) in enumerate(rows):
        mesh = scene.meshes[mid]
        mat = scene.materials[mesh.material]
        if np.linalg.norm(np.asarray(mat.emission)) < 1e-3:
            continue
        mask = t_inst == inst_id
        a, b, c = pw[i0[mask]], pw[i1[mask]], pw[i2[mask]]
        areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
        if len(areas) == 0:
            continue
        lights_inst.append(inst_id)
        cdf_start.append(sum(len(x) for x in cdf_all))
        cdf_count.append(len(areas))
        env.append(INVALID_ID)
        cdf_all.append(np.cumsum(areas).astype(np.float32))
    if not lights_inst:
        return LightTable.empty()
    return LightTable(
        instance=_t(np.array(lights_inst, np.int32)),
        cdf_start=_t(np.array(cdf_start, np.int32)),
        cdf_count=_t(np.array(cdf_count, np.int32)),
        environment=_t(np.array(env, np.int32)),
        cdf=_t(np.concatenate(cdf_all)))


def _generate_blue_noise(size: int, seed: int):
    """High-pass-filtered white noise ranked to uniform [0, 1)."""
    rng = np.random.default_rng(seed)
    white = rng.random((size, size, 4)).astype(np.float32)
    blur = np.zeros_like(white)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            blur += np.roll(np.roll(white, dy, 0), dx, 1)
    blur /= 9.0
    shaped = white - 0.5 * (blur - 0.5)
    ranks = shaped.reshape(-1, 4).argsort(axis=0).argsort(axis=0)
    out = (ranks.astype(np.float32) + 0.5) / (size * size)
    return out.reshape(size, size, 4)


# --- canned scenes ----------------------------------------------------------

def cube_scene() -> Scene:
    """A single cube on a ground plane, one directional sun."""
    sc = Scene("cube")
    m_floor = sc.add_material(Material(name="floor", colour=(0.6, 0.6, 0.6),
                                       roughness=0.9))
    m_cube = sc.add_material(Material(name="red", colour=(0.8, 0.15, 0.1),
                                      roughness=0.4, metallic=0.1))
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = [0.0, 0.75, 0.0]
    sc.add_entity(sc.add_mesh(geometry.plane(size=20.0, material=m_floor)),
                  name="floor")
    sc.add_entity(sc.add_mesh(geometry.cube(size=1.5, material=m_cube)), t,
                  name="cube")
    sc.set_sun((-1.0, -1.0, -0.5), intensity=3.0)
    return sc


def cornell_scene() -> Scene:
    """Cornell-style box with an emissive ceiling quad."""
    sc = Scene("cornell")
    white = sc.add_material(Material(name="white", colour=(0.73, 0.73, 0.73),
                                     roughness=0.9, double_sided=True))
    red = sc.add_material(Material(name="red", colour=(0.65, 0.05, 0.05),
                                   roughness=0.9, double_sided=True))
    green = sc.add_material(Material(name="green", colour=(0.12, 0.45, 0.15),
                                     roughness=0.9, double_sided=True))
    lightm = sc.add_material(Material(name="light", colour=(1, 1, 1),
                                      emission=(15.0, 15.0, 15.0),
                                      double_sided=True))
    metal = sc.add_material(Material(name="metal", colour=(0.8, 0.8, 0.9),
                                     roughness=0.1, metallic=1.0))
    s = 5.0
    q = geometry.quad_facing
    sc.add_entity(sc.add_mesh(q((0, 1, 0), (0, 0, 0), s * 2, white)))
    sc.add_entity(sc.add_mesh(q((0, -1, 0), (0, s, 0), s * 2, white)))
    sc.add_entity(sc.add_mesh(q((0, 0, 1), (0, s / 2, -s / 2), s * 2, white)))
    sc.add_entity(sc.add_mesh(q((1, 0, 0), (-s / 2, s / 2, 0), s * 2, red)))
    sc.add_entity(sc.add_mesh(q((-1, 0, 0), (s / 2, s / 2, 0), s * 2, green)))
    sc.add_entity(sc.add_mesh(q((0, -1, 0), (0, s - 0.01, 0), 1.5, lightm)))
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = [-1.0, 0.75, -0.5]
    sc.add_entity(sc.add_mesh(geometry.cube(1.5, white)), t)
    t2 = np.eye(4, dtype=np.float32)
    t2[:3, 3] = [1.2, 0.6, 0.8]
    sc.add_entity(sc.add_mesh(geometry.uv_sphere(0.6, material=metal)), t2)
    sc.set_sun((-0.3, -1.0, -0.2), intensity=0.0)
    return sc


def stress_scene(num_objects=400, seed=0) -> Scene:
    """The procedural stress scene: floor, columns and random boxes and
    spheres (250 objects → 65,258 triangles). Untextured only."""
    sc = Scene("stress")
    sc.add_material(Material(name="floor", colour=(0.55, 0.5, 0.45),
                             roughness=0.8))
    sc.add_material(Material(name="column", colour=(0.7, 0.68, 0.6),
                             roughness=0.6))
    sc.add_material(Material(name="sphere", colour=(0.3, 0.4, 0.7),
                             roughness=0.3, metallic=0.4))
    sc.add_material(Material(name="box", colour=(0.7, 0.3, 0.2),
                             roughness=0.5))
    sc.add_model(geometry.stress_scene_meshes(num_objects, seed))
    sc.set_sun((-0.4, -1.0, -0.3), intensity=3.0)
    return sc
