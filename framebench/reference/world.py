"""The scene as the reference sees it: every entity's mesh placed in
the world by its transform, from the benchmark's own arrays
(scenegen.SceneDesc), on the device.

A moved entity (``move``) takes its new transform; the transforms the
frame before held become every entity's previous ones, from which the
motion vectors follow."""
from __future__ import annotations

import numpy as np
import torch

# a material's fields where the description leaves them out
MATERIAL_DEFAULTS = dict(colour=(0.8, 0.8, 0.8), emission=(0.0, 0.0, 0.0),
                         roughness=0.5, metallic=0.0, colour_texture=-1,
                         double_sided=False)
# the sun's colour and ambient strength where the scene gives only its
# direction and intensity
SUN_COLOUR = (1.0, 1.0, 1.0)
SUN_AMBIENT = 0.05
MIN_ROUGHNESS = 0.03 * 0.03


class World:
    def __init__(self, desc, device):
        self.device = device
        pos, nrm, uv, tris, v_ent, t_ent = [], [], [], [], [], []
        base = 0
        for e, m in enumerate(desc.meshes):
            pos.append(m.positions)
            nrm.append(m.normals)
            uv.append(m.uvs)
            tris.append(m.indices.reshape(-1, 3).astype(np.int64) + base)
            v_ent.append(np.full(len(m.positions), e, np.int64))
            t_ent.append(np.full(len(m.indices) // 3, e, np.int64))
            base += len(m.positions)

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(np.concatenate(x)),
                                   dtype=dtype, device=device)

        self.local_pos, self.local_nrm, self.uv = t(pos), t(nrm), t(uv)
        self.tris = t(tris, torch.int64)                     # (T, 3)
        self.vert_entity = t(v_ent, torch.int64)
        self.tri_entity = t(t_ent, torch.int64)
        ent_material = torch.as_tensor(
            [m.material for m in desc.meshes], device=device)
        self.tri_material = ent_material[self.tri_entity]

        mats = [dict(MATERIAL_DEFAULTS, **m) for m in desc.materials]

        def col(key, dtype=torch.float32):
            return torch.as_tensor(np.asarray([m[key] for m in mats]),
                                   dtype=dtype, device=device)

        self.mat_colour, self.mat_emission = col("colour"), col("emission")
        r = col("roughness")
        r2 = r * r
        # the squared roughness, nought below the smallest
        self.mat_rough2 = torch.where(r2 < MIN_ROUGHNESS,
                                      torch.zeros_like(r2), r2)
        self.mat_metal = col("metallic")
        self.mat_texture = col("colour_texture", torch.int64)
        # single-sided triangles are culled where they face away
        self.tri_single_sided = ~col("double_sided", torch.bool)[
            self.tri_material]
        self.textures = None
        if desc.textures is not None:
            data, sizes = desc.textures
            self.textures = (torch.as_tensor(data, device=device),
                             torch.as_tensor(sizes, dtype=torch.int64,
                                             device=device))

        d = np.asarray(desc.sun["direction"], np.float32)
        d = d / np.linalg.norm(d)
        to_sun = -d.astype(np.float64)
        self.to_sun = torch.as_tensor(
            (to_sun / np.linalg.norm(to_sun)).astype(np.float32),
            device=device)
        self.sun_radiance = torch.as_tensor(
            np.asarray(SUN_COLOUR, np.float32)
            * np.float32(desc.sun["intensity"]), device=device)
        self.ambient = SUN_AMBIENT

        self.transforms = np.asarray(desc.transforms, np.float32).copy()
        self.prev_transforms = self.transforms.copy()
        self._place()

    def move(self, transforms: dict):
        """Entities → their new transforms; every entity's previous
        transform becomes the one it held until now."""
        self.prev_transforms = self.transforms.copy()
        for e, tf in transforms.items():
            self.transforms[e] = np.asarray(tf, np.float32)
        self._place()

    def _place(self):
        def per_vertex(tf):
            return torch.as_tensor(tf, device=self.device)[self.vert_entity]

        def apply(m, p):                      # (V, 4, 4) on (V, 3) points
            return torch.einsum("vij,vj->vi", m[:, :3, :3], p) + m[:, :3, 3]

        cur = per_vertex(self.transforms)
        self.world_pos = apply(cur, self.local_pos)
        self.prev_world_pos = apply(per_vertex(self.prev_transforms),
                                    self.local_pos)
        # normals go through the inverse transpose of each transform
        nmat = np.transpose(np.linalg.inv(
            self.transforms[:, :3, :3].astype(np.float64)), (0, 2, 1))
        self.normal_matrix = torch.as_tensor(nmat.astype(np.float32),
                                             device=self.device)  # (E, 3, 3)
        self.world_nrm = torch.einsum(
            "vij,vj->vi", self.normal_matrix[self.vert_entity],
            self.local_nrm)

    def corners(self, per_vertex):
        """A (V, C) per-vertex table → (T, 3, C), each triangle's
        corners in order."""
        return per_vertex[self.tris]
