"""PBR shading math (hybridrenderer_tpu/ops/shade.py), elementwise over
leading dims."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core import maths
from . import texture as tex_ops

PI = 3.14159265359
MIN_ROUGHNESS = 0.03 * 0.03


def luminance(rgb):
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def eta_to_reflectivity(eta):
    return ((eta - 1.0) ** 2) / ((eta + 1.0) ** 2)


def fresnel_schlick(specular, normal, outgoing):
    cosine = maths.dot(normal, outgoing, keepdim=True)
    f = specular + (1.0 - specular) * torch.clamp(
        1.0 - torch.abs(cosine), 0.0, 1.0) ** 5
    nonzero = torch.any(specular != 0.0, dim=-1, keepdim=True)
    return torch.where(nonzero, f, torch.zeros_like(f))


def microfacet_distribution(roughness, normal, halfway):
    cosine = maths.dot(normal, halfway)
    r2 = roughness * roughness
    c2 = cosine * cosine
    denom = c2 * (r2 - 1.0) + 1.0
    d = r2 / (PI * denom * denom)
    return torch.where(cosine > 0.0, d, torch.zeros_like(d))


def _microfacet_shadowing1(roughness, normal, halfway, direction):
    cosine = maths.dot(normal, direction)
    c2 = cosine * cosine
    cosine_h = maths.dot(halfway, direction)
    r2 = roughness * roughness
    g = 2.0 / (torch.sqrt(torch.clamp(
        ((r2 * (1.0 - c2)) + c2) / torch.clamp(c2, min=1e-12), min=0.0)) + 1.0)
    return torch.where(cosine * cosine_h > 0.0, g, torch.zeros_like(g))


def microfacet_shadowing(roughness, normal, halfway, outgoing, incoming):
    return (_microfacet_shadowing1(roughness, normal, halfway, outgoing)
            * _microfacet_shadowing1(roughness, normal, halfway, incoming))


def eval_pbr(colour, ior, roughness, metallic, normal, outgoing, incoming):
    """EvalPbr: diffuse + specular, cosine-weighted. ``roughness`` and
    ``metallic`` are (...) and broadcast against (..., 3) vectors."""
    metallic_ = metallic.unsqueeze(-1)
    reflectivity = maths.mix(
        torch.full_like(colour, eta_to_reflectivity(float(ior))),
        colour, metallic_)
    n_dot_o = maths.dot(normal, outgoing, keepdim=True)
    up_normal = torch.where(n_dot_o <= 0.0, -normal, normal)
    f1 = fresnel_schlick(reflectivity, up_normal, outgoing)
    halfway = maths.normalize(incoming + outgoing)
    f = fresnel_schlick(reflectivity, halfway, incoming)
    d = microfacet_distribution(roughness, up_normal, halfway).unsqueeze(-1)
    g = microfacet_shadowing(roughness, up_normal, halfway, outgoing,
                             incoming).unsqueeze(-1)

    cosine = torch.abs(maths.dot(up_normal, incoming, keepdim=True))
    diffuse = colour * (1.0 - metallic_) * (1.0 - f1) / PI
    denom = 4.0 * torch.abs(maths.dot(up_normal, outgoing, keepdim=True)) * \
        torch.abs(maths.dot(up_normal, incoming, keepdim=True))
    specular = f * d * g / torch.clamp(denom, min=1e-8)

    result = (diffuse + specular) * cosine
    visible = (maths.dot(normal, incoming) * maths.dot(normal, outgoing)
               > 0.0).unsqueeze(-1)
    return torch.where(visible, result, torch.zeros_like(result))


@dataclasses.dataclass
class MaterialPoint:
    colour: Any      # (..., 3)
    emission: Any    # (..., 3)
    roughness: Any   # (...) squared-roughness convention
    metallic: Any    # (...)
    opacity: Any     # (...)
    material_type: Any  # (...) int32


def pack_materials(materials):
    """(M, 16) material rows: colour|opacity|emission|roughness|metallic|
    type|colour, emission, roughness, normal texture ids|alpha mode|cutoff."""
    f = torch.float32
    return torch.cat([
        materials.colour,
        materials.opacity[:, None],
        materials.emission,
        materials.roughness[:, None],
        materials.metallic[:, None],
        materials.material_type[:, None].to(f),
        materials.colour_texture[:, None].to(f),
        materials.emission_texture[:, None].to(f),
        materials.roughness_texture[:, None].to(f),
        materials.normal_texture[:, None].to(f),
        materials.alpha_mode[:, None].to(f),
        materials.alpha_cutoff[:, None],
    ], dim=-1)


def material_point_from_row(row, uv, textures) -> MaterialPoint:
    """Surface point from a packed (..., 16) material row: the colour and
    opacity, emission and roughness / metallic (channels 1 and 2) slots
    modulated by their textures. A slot no material binds
    (``textures.slot_usage``) is not sampled; sampling it would multiply
    by the default 1.0, which changes no bit."""
    colour = row[..., 0:3]
    opacity = row[..., 3]
    emission = row[..., 4:7]
    roughness = row[..., 7]
    metallic = row[..., 8]
    used = textures.slot_usage
    if tex_ops.has_textures(textures):
        ones = (1.0, 1.0, 1.0, 1.0)
        if used[0]:
            albedo = tex_ops.sample_stack(
                textures, row[..., 10].to(torch.int32), uv, ones)
            colour = colour * albedo[..., :3]
            opacity = opacity * albedo[..., 3]
        if used[1]:
            em = tex_ops.sample_stack(
                textures, row[..., 11].to(torch.int32), uv, ones)
            emission = emission * em[..., :3]
        if used[2]:
            mr = tex_ops.sample_stack(
                textures, row[..., 12].to(torch.int32), uv, ones)
            roughness = roughness * mr[..., 1]
            metallic = metallic * mr[..., 2]
    r2 = roughness * roughness
    r2 = torch.where(r2 < MIN_ROUGHNESS, torch.zeros_like(r2), r2)
    return MaterialPoint(colour=colour, emission=emission, roughness=r2,
                         metallic=metallic, opacity=opacity,
                         material_type=row[..., 9].to(torch.int32))


def uses_normal_map(textures) -> bool:
    """Whether any material binds a normal texture; without one the
    tangent frame is never read, so callers skip building it."""
    return tex_ops.has_textures(textures) and textures.slot_usage[3]


def apply_normal_map(materials, mat_id, shading_normal, tangent, uv,
                     textures, nrm_tex_id=None):
    """CalculateNormal: the normal map's texel, in [0, 1] per channel,
    taken to [-1, 1] and through the TBN frame of ``shading_normal`` and
    ``tangent`` (..., 4) (w is the bitangent's sign, 1 where |w| <
    0.001). The normalized normal where the material binds no normal
    texture or the tangent is shorter than 0.001. ``nrm_tex_id`` is the
    normal texture id when already fetched (the material row's column
    13), else it is looked up by ``mat_id``."""
    if not uses_normal_map(textures):
        return maths.normalize(shading_normal)
    if nrm_tex_id is None:
        nrm_tex_id = materials.normal_texture[mat_id.long()]
    n = maths.normalize(shading_normal)
    t = maths.normalize(tangent[..., :3])
    t_len = maths.length(tangent[..., :3])
    w = tangent[..., 3]
    sign = torch.where(torch.abs(w) < 0.001, torch.ones_like(w), w)
    b = maths.cross(n, t) * sign.unsqueeze(-1)
    nm = tex_ops.sample_stack(textures, nrm_tex_id, uv,
                              (0.5, 0.5, 1.0, 1.0))[..., :3] * 2.0 - 1.0
    mapped = maths.normalize(t * nm[..., 0:1] + b * nm[..., 1:2]
                             + n * nm[..., 2:3])
    use = ((nrm_tex_id >= 0) & (t_len >= 0.001)).unsqueeze(-1)
    return torch.where(use, mapped, n)
