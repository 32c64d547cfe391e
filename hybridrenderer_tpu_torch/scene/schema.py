"""Scene data schemas as tensor dataclasses
(hybridrenderer_tpu/scene/schema.py).

Field names and layouts are the reference's, so the JAX SceneData can be
carried over field by field (scene/convert.py). Only what the hybrid
path reads is kept; the reference's TPU-specific gather tables
(shade_rows, shade_rows_q, inst_shade, texture quads) are not.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.types import INVALID_ID, MaterialType


def _to(obj, device):
    """Copy of a tensor dataclass with every tensor field on ``device``."""
    vals = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(device)
        elif dataclasses.is_dataclass(v):
            v = _to(v, device)
        vals[f.name] = v
    return type(obj)(**vals)


@dataclasses.dataclass
class MaterialTable:
    emission: Any          # (M, 3) f32
    colour: Any            # (M, 3) f32
    roughness: Any         # (M,)   f32
    metallic: Any          # (M,)   f32
    opacity: Any           # (M,)   f32
    anisotropy: Any        # (M,)   f32
    material_type: Any     # (M,)   i32
    scattering_colour: Any  # (M, 3) f32
    transmission_depth: Any  # (M,) f32
    emission_texture: Any  # (M,) i32, -1 = none
    colour_texture: Any    # (M,) i32
    roughness_texture: Any  # (M,) i32
    normal_texture: Any    # (M,) i32
    alpha_mode: Any        # (M,) i32: 0 opaque, 1 alpha-mask (cut-out)
    alpha_cutoff: Any      # (M,) f32
    double_sided: Any      # (M,) i32

    @staticmethod
    def build(mats: list["Material"]) -> "MaterialTable":
        def f(get, dt=np.float32):
            return torch.from_numpy(np.array([get(m) for m in mats], dtype=dt))

        return MaterialTable(
            emission=f(lambda m: m.emission),
            colour=f(lambda m: m.colour),
            roughness=f(lambda m: m.roughness),
            metallic=f(lambda m: m.metallic),
            opacity=f(lambda m: m.opacity),
            anisotropy=f(lambda m: m.anisotropy),
            material_type=f(lambda m: int(m.material_type), np.int32),
            scattering_colour=f(lambda m: m.scattering_colour),
            transmission_depth=f(lambda m: m.transmission_depth),
            emission_texture=f(lambda m: m.emission_texture, np.int32),
            colour_texture=f(lambda m: m.colour_texture, np.int32),
            roughness_texture=f(lambda m: m.roughness_texture, np.int32),
            normal_texture=f(lambda m: m.normal_texture, np.int32),
            alpha_mode=f(lambda m: m.alpha_mode, np.int32),
            alpha_cutoff=f(lambda m: m.alpha_cutoff),
            double_sided=f(lambda m: int(m.double_sided), np.int32),
        )


@dataclasses.dataclass
class Material:
    """Host-side named material."""

    name: str = "material"
    colour: tuple = (0.8, 0.8, 0.8)
    emission: tuple = (0.0, 0.0, 0.0)
    roughness: float = 0.5
    metallic: float = 0.0
    opacity: float = 1.0
    anisotropy: float = 0.0
    material_type: MaterialType = MaterialType.PBR
    scattering_colour: tuple = (0.0, 0.0, 0.0)
    transmission_depth: float = 0.0
    emission_texture: int = INVALID_ID
    colour_texture: int = INVALID_ID
    roughness_texture: int = INVALID_ID
    normal_texture: int = INVALID_ID
    alpha_mode: int = 0
    alpha_cutoff: float = 0.5
    double_sided: bool = False


@dataclasses.dataclass
class InstanceTable:
    transform: Any        # (N, 4, 4)
    inverse_transform: Any
    normal_transform: Any  # (N, 4, 4)
    prev_transform: Any   # (N, 4, 4)
    aabb_min: Any         # (N, 3) world-space
    aabb_max: Any         # (N, 3)
    material: Any         # (N,) i32
    vertex_offset: Any    # (N,) i32
    index_offset: Any     # (N,) i32
    index_count: Any      # (N,) i32
    selected: Any         # (N,) i32


@dataclasses.dataclass
class VertexArrays:
    position: Any        # (V, 3) local space
    world_position: Any  # (V, 3) world space
    normal: Any          # (V, 3)
    tangent: Any         # (V, 4)
    uv: Any              # (V, 2)


@dataclasses.dataclass
class LightTable:
    """Emissive-instance lights + concatenated triangle-area CDFs."""

    instance: Any     # (L,) i32 instance id or -1
    cdf_start: Any    # (L,) i32
    cdf_count: Any    # (L,) i32
    environment: Any  # (L,) i32
    cdf: Any          # (C,) f32

    @property
    def count(self) -> int:
        return self.instance.shape[0]

    @staticmethod
    def empty() -> "LightTable":
        zi = torch.zeros((0,), dtype=torch.int32)
        return LightTable(zi, zi, zi, zi, torch.zeros((1,), dtype=torch.float32))


@dataclasses.dataclass
class TextureStack:
    """The bindless texture array: every texture padded into one
    (N, H, W, 4) f32 stack, linear colour; ``sizes`` holds each one's
    true (height, width), which the sampler wraps by (ops/texture.py).

    ``slot_usage`` says whether any material binds a (colour, emission,
    roughness, normal) texture; a slot no material binds is not sampled.
    The reference's quad-texel bake, u8 storage and window atlas are TPU
    gather workarounds that give the same samples; the port has none."""

    data: Any   # (N, H, W, 4) f32; (1, 1, 1, 4) when no texture is bound
    sizes: Any  # (N, 2) i32 (height, width) in use
    slot_usage: tuple = (True, True, True, True)

    @staticmethod
    def empty() -> "TextureStack":
        return TextureStack(data=torch.zeros((1, 1, 1, 4)),
                            sizes=torch.ones((1, 2), dtype=torch.int32),
                            slot_usage=(False, False, False, False))

    def finalized(self, materials: "MaterialTable") -> "TextureStack":
        """The stack with ``slot_usage`` derived from the materials."""
        usage = tuple(bool((t >= 0).any()) for t in (
            materials.colour_texture, materials.emission_texture,
            materials.roughness_texture, materials.normal_texture))
        return dataclasses.replace(self, slot_usage=usage)


@dataclasses.dataclass
class TriangleSoup:
    """World-space flattened triangles in global primitive order."""

    v0: Any        # (T, 3)
    v1: Any        # (T, 3)
    v2: Any        # (T, 3)
    instance: Any  # (T,) i32
    i0: Any        # (T,) i32 global vertex indices
    i1: Any
    i2: Any
    single_sided: Any  # (T,) bool: back-face cullable

    @property
    def count(self) -> int:
        return self.instance.shape[0]


@dataclasses.dataclass
class SunLight:
    direction: Any  # (3,) from the sun toward the scene
    color: Any      # (3,)
    intensity: Any  # () scalar
    ambient: Any    # () ambient strength

    @staticmethod
    def default() -> "SunLight":
        d = np.array([-1.0, -1.0, -1.0], np.float32)
        d /= np.linalg.norm(d)
        return SunLight(direction=torch.from_numpy(d),
                        color=torch.ones(3),
                        intensity=torch.tensor(3.0),
                        ambient=torch.tensor(0.05))


@dataclasses.dataclass
class SceneData:
    """The complete scene on one device."""

    materials: MaterialTable
    instances: InstanceTable
    vertices: VertexArrays
    indices: Any          # (I,) i32
    triangles: TriangleSoup
    lights: LightTable
    textures: TextureStack
    sun: SunLight
    sky_texture: int      # -1 = procedural sky
    blue_noise: Any       # (Hn, Wn, 4) f32
    has_alpha_test: bool = False
    has_sky_texture: bool = False
    attr_rows: Any = None    # (T, 84), layout below
    raster_rows: Any = None  # (T, 72), layout below

    @property
    def num_triangles(self) -> int:
        return self.triangles.count

    @property
    def device(self) -> torch.device:
        return self.triangles.v0.device

    def to(self, device) -> "SceneData":
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: build the scene with "
                               "device='cpu' to render on the CPU")
        return _to(self, device)


# attr_rows layout: vertex k at 15*k — [0:3] world position, [3:6] local
# position, [6:9] normal, [9:13] tangent, [13:15] uv; instance block at
# 45 — [45:54] normal matrix (3x3 row-major), [54:66] prev transform
# (3x4), [66] material id, [67:83] packed material row, [83] instance id

# raster_rows layout (T, 72): vertex k at 16*k — [0:3] world position,
# [3:6] previous world position, [6:9] world normal (unnormalized),
# [9:12] world tangent xyz, [12] tangent w, [13:15] uv, [15] pad;
# constants at 48 — [48:64] packed material row, [64] material id,
# [65] instance id, [66:72] pad


def _subset(soup, tris):
    """(i0, i1, i2, instance) of every triangle, or of the rows ``tris``."""
    cols = (soup.i0, soup.i1, soup.i2, soup.instance)
    if tris is not None:
        tris = tris.long()
        cols = tuple(c[tris] for c in cols)
    return tuple(c.long() for c in cols)


def build_attr_rows(vertices, instances, soup, materials, tris=None):
    """One (T, 84) f32 row per triangle (layout above); with ``tris``
    (D,), the rows of those triangles only (D, 84), equal to the full
    build's rows there (the dirty-only dynamic update)."""
    from ..ops.shade import pack_materials  # local: avoid import cycle

    vpack = torch.cat([vertices.world_position, vertices.position,
                       vertices.normal, vertices.tangent, vertices.uv],
                      dim=-1)
    n = instances.transform.shape[0]
    mat_ids = instances.material.long()
    ipack = torch.cat([
        instances.normal_transform[:, :3, :3].reshape(n, 9),
        instances.prev_transform[:, :3, :4].reshape(n, 12),
        mat_ids[:, None].float(),
        pack_materials(materials)[mat_ids]], dim=-1)
    i0, i1, i2, inst = _subset(soup, tris)
    return torch.cat([vpack[i0], vpack[i1], vpack[i2], ipack[inst],
                      inst[:, None].float()], dim=-1)


def build_raster_rows(vertices, instances, soup, materials, tris=None):
    """One (T, 72) f32 row per triangle (layout above): the per-vertex
    attributes the raster kernel interpolates, with every instance
    transform already applied, and the winner's constants; ``tris``
    scopes it to those triangles, as for ``build_attr_rows``."""
    from ..ops.shade import pack_materials  # local: avoid import cycle

    i0, i1, i2, inst = _subset(soup, tris)
    nmat = instances.normal_transform[inst][:, :3, :3]
    ptf = instances.prev_transform[inst][:, :3, :]
    T = inst.shape[0]

    def vert(ik):
        lp = vertices.position[ik]
        wn = torch.einsum("tij,tj->ti", nmat, vertices.normal[ik])
        tg = vertices.tangent[ik]
        wt = torch.einsum("tij,tj->ti", nmat, tg[:, :3])
        pwp = torch.einsum("tij,tj->ti", ptf[..., :3], lp) + ptf[..., 3]
        return torch.cat([vertices.world_position[ik], pwp, wn, wt,
                          tg[:, 3:4], vertices.uv[ik],
                          torch.zeros((T, 1), device=lp.device)], dim=-1)

    mat_ids = instances.material.long()[inst]
    const = torch.cat([
        pack_materials(materials)[mat_ids],
        mat_ids[:, None].float(),
        inst[:, None].float(),
        torch.zeros((T, 6), device=nmat.device)], dim=-1)
    return torch.cat([vert(i0), vert(i1), vert(i2), const], dim=-1)
