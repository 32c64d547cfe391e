"""Scene data schemas as tensor dataclasses
(hybridrenderer_tpu/scene/schema.py).

Field names and layouts are the reference's, so the JAX SceneData can be
carried over field by field (scene/convert.py). Only what the port reads
is kept: the reference's exact u16 ``shade_rows`` (a bitcast of
attr_rows columns) and its texture quads are TPU gather tables that
give the same values, and are not. Its quantized ``shade_rows_q`` and
``inst_shade`` are kept, because above 98,304 triangles the reference
shades radiance hits from them and the image changes with them.
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
    # the quantized hit-shading table and its per-instance side table
    # (layouts below), set where the reference shades from them
    # (shade_table_kind); None where it shades from exact values
    shade_rows_q: Any = None  # (T, 29) i32 holding u16 values
    inst_shade: Any = None    # (N, 26) f32

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


# The reference's hit shading reads 53 attr_rows columns (SHADE_COLS,
# its _SHADE_COLS) decoded into this layout: vertex k at 9k — [0:3]
# normal, [3:7] tangent, [7:9] uv; [27:36] normal matrix (3x3 row-major),
# [36] material id, [37:53] packed material row. At most SHADE_ROWS_MAX
# triangles it fetches them exactly (its u16 shade_rows); above, up to
# SHADE_Q_ROWS_MAX triangles and 65,536 instances, from the quantized
# table below; beyond those, exactly from attr_rows again.
SHADE_COLS = (list(range(6, 15)) + list(range(21, 30)) + list(range(36, 45))
              + list(range(45, 54)) + [66] + list(range(67, 83)))
SHADE_ROWS_MAX = 98304

# shade_rows_q, (T, 29) u16 values a triangle, transform-invariant:
#   [0:9]   vertex normals (3 x xyz, local space), bf16 bit patterns
#           (truncated, not rounded)
#   [9:18]  vertex tangents xyz (local space), bf16 bit patterns
#   [18]    tangent w signs: bit k set means vertex k's w = +1, else -1
#   [19:23] uv0 exactly (u hi, u lo, v hi, v lo: f32 bit halves)
#   [23:27] (uv1 - uv0, uv2 - uv0) as f16 bit patterns
#   [27]    material id  [28] instance id
# inst_shade, (N, 26) f32 an instance, follows transforms: [0:9] normal
# matrix, [9:25] packed material row, [25] material id.
SHQ_WIDTH = 29
SHQ_N0 = 0
SHQ_T0 = 9
SHQ_WSIGN = 18
SHQ_UV0 = 19
SHQ_DUV = 23
SHQ_MAT = 27
SHQ_INST = 28
SHADE_Q_MAX_BYTES = 16 * 1024 * 1024
SHADE_Q_ROWS_MAX = SHADE_Q_MAX_BYTES // (2 * SHQ_WIDTH)
SHADE_Q_INSTANCES_MAX = 65536
SHQI_NMAT = 0
SHQI_MROW = 9
SHQI_MAT = 25
SHQI_WIDTH = 26


def shade_table_kind(num_triangles: int, num_instances: int) -> str:
    """The table the reference's hit shading reads for a scene of these
    sizes (its Scene.build, scene.py:236-244): "shade_rows" (exact, at
    most SHADE_ROWS_MAX triangles), "shade_rows_q" (quantized) or
    "attr_rows" (exact, where neither fits)."""
    if num_triangles <= SHADE_ROWS_MAX:
        return "shade_rows"
    if num_triangles <= SHADE_Q_ROWS_MAX \
            and num_instances <= SHADE_Q_INSTANCES_MAX:
        return "shade_rows_q"
    return "attr_rows"


# Bit work in int32 (torch's uint16 lacks most operations): a u16 value
# is an int32 in [0, 65535].
def _signed16(b):
    """u16 values (int32) → int16 with the same bits."""
    return torch.where(b >= 32768, b - 65536, b).to(torch.int16)


def _u32_to_f32(v):
    """u32 bit patterns (int64) → f32."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(
        torch.int32).view(torch.float32)


def _f32_to_bf16_bits(x):
    """The upper half of each f32's bits: bf16 by truncation."""
    return (x.to(torch.float32).contiguous().view(torch.int32) >> 16) \
        & 0xFFFF


def _bf16_bits_to_f32(b):
    return _signed16(b).view(torch.bfloat16).to(torch.float32)


def _f32_to_f16_bits(x):
    """f16 by round to nearest even, overflowing to inf."""
    return x.to(torch.float16).view(torch.int16).to(torch.int32) & 0xFFFF


def _f16_bits_to_f32(b):
    return _signed16(b).view(torch.float16).to(torch.float32)


def build_shade_rows_q(vertices, instances, soup):
    """(T, 29) i32 quantized shade rows (layout above), or None above
    SHADE_Q_ROWS_MAX triangles or SHADE_Q_INSTANCES_MAX instances. No
    column depends on a transform, so dynamic updates leave the table;
    only ``build_inst_shade`` follows them."""
    T = soup.i0.shape[0]
    if T > SHADE_Q_ROWS_MAX \
            or instances.transform.shape[0] > SHADE_Q_INSTANCES_MAX:
        return None
    ik = [i.long() for i in (soup.i0, soup.i1, soup.i2)]
    n_bits = torch.cat([_f32_to_bf16_bits(vertices.normal[i]) for i in ik],
                       dim=-1)
    t_bits = torch.cat([_f32_to_bf16_bits(vertices.tangent[i][:, :3])
                        for i in ik], dim=-1)
    wsign = sum((vertices.tangent[i][:, 3] > 0.0).to(torch.int32) << k
                for k, i in enumerate(ik))
    uv0 = vertices.uv[ik[0]]
    bits = uv0.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    uv0_cols = torch.stack([bits[:, 0] >> 16, bits[:, 0] & 0xFFFF,
                            bits[:, 1] >> 16, bits[:, 1] & 0xFFFF],
                           dim=-1).to(torch.int32)
    duv = torch.cat([vertices.uv[ik[1]] - uv0, vertices.uv[ik[2]] - uv0],
                    dim=-1)
    inst = soup.instance.long()
    mat = instances.material.long()[inst].to(torch.int32) & 0xFFFF
    return torch.cat([n_bits, t_bits, wsign.unsqueeze(-1), uv0_cols,
                      _f32_to_f16_bits(duv), mat.unsqueeze(-1),
                      (inst.to(torch.int32) & 0xFFFF).unsqueeze(-1)],
                     dim=-1).contiguous()


def build_inst_shade(instances, materials):
    """(N, 26) f32 per-instance side table of the quantized rows: the
    normal matrix, the packed material row and the material id."""
    from ..ops.shade import pack_materials  # local: avoid import cycle

    n = instances.transform.shape[0]
    mat_ids = instances.material.long()
    return torch.cat([instances.normal_transform[:, :3, :3].reshape(n, 9),
                      pack_materials(materials)[mat_ids],
                      mat_ids[:, None].float()], dim=-1)


def decode_shade_rows_q(qrow, inst_row):
    """(..., 29) quantized rows and their instances' (..., 26) side rows
    → the (..., 53) f32 hit-shading layout above; vertex k's uv is uv0
    plus its f16 delta (vertex 0's exact)."""
    u = ((qrow[..., SHQ_UV0].long() << 16) | qrow[..., SHQ_UV0 + 1].long())
    v = ((qrow[..., SHQ_UV0 + 2].long() << 16) | qrow[..., SHQ_UV0 + 3].long())
    uv0 = torch.stack([_u32_to_f32(u), _u32_to_f32(v)], dim=-1)
    parts = []
    for k in range(3):
        n = _bf16_bits_to_f32(qrow[..., SHQ_N0 + 3 * k:SHQ_N0 + 3 * k + 3])
        t3 = _bf16_bits_to_f32(qrow[..., SHQ_T0 + 3 * k:SHQ_T0 + 3 * k + 3])
        w = torch.where((qrow[..., SHQ_WSIGN:SHQ_WSIGN + 1] & (1 << k)) > 0,
                        1.0, -1.0)
        uv = uv0 if k == 0 else uv0 + _f16_bits_to_f32(
            qrow[..., SHQ_DUV + 2 * (k - 1):SHQ_DUV + 2 * k])
        parts += [n, t3, w, uv]
    return torch.cat(parts + [inst_row[..., SHQI_NMAT:SHQI_NMAT + 9],
                              inst_row[..., SHQI_MAT:SHQI_MAT + 1],
                              inst_row[..., SHQI_MROW:SHQI_MROW + 16]],
                     dim=-1)


def set_shade_tables(data):
    """Give ``data`` the quantized tables where the reference builds them
    (``shade_table_kind``), and None elsewhere."""
    q = None
    if shade_table_kind(data.num_triangles,
                        data.instances.transform.shape[0]) == "shade_rows_q":
        q = build_shade_rows_q(data.vertices, data.instances, data.triangles)
    data.shade_rows_q = q
    data.inst_shade = None if q is None else build_inst_shade(
        data.instances, data.materials)
    return data
