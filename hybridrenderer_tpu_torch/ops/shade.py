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
    """Surface point from a packed (..., 16) material row; bound
    textures raise (ops/texture.py)."""
    colour = row[..., 0:3]
    opacity = row[..., 3]
    emission = row[..., 4:7]
    roughness = row[..., 7]
    metallic = row[..., 8]
    if tex_ops.has_textures(textures):
        albedo = tex_ops.sample_stack(textures, row[..., 10].to(torch.int32),
                                      uv, (1.0, 1.0, 1.0, 1.0))
        colour = colour * albedo[..., :3]
        opacity = opacity * albedo[..., 3]
    r2 = roughness * roughness
    r2 = torch.where(r2 < MIN_ROUGHNESS, torch.zeros_like(r2), r2)
    return MaterialPoint(colour=colour, emission=emission, roughness=r2,
                         metallic=metallic, opacity=opacity,
                         material_type=row[..., 9].to(torch.int32))


def apply_normal_map(shading_normal, textures):
    """CalculateNormal without a normal texture: the normalized normal."""
    if tex_ops.has_textures(textures):
        raise NotImplementedError("normal mapping is not ported yet")
    return maths.normalize(shading_normal)
