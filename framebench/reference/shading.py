"""Shading arithmetic of the reference: the ray-direction patterns,
the ray-origin offset, the PBR terms, the procedural sky, the texture
filter and the tone curve, each written out plainly."""
from __future__ import annotations

import numpy as np
import torch

PI = 3.14159265359
AO_SALT = 0x51AB7000
GI_SALT = 0x7D1E6100
PATTERNS = 4          # the direction pattern repeats every 4 x 4 blocks


def dot(a, b, keep=False):
    out = (a * b).sum(-1)
    return out.unsqueeze(-1) if keep else out


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def unit(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def luminance(rgb):
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


# --- directions -----------------------------------------------------------

def _tea(a: np.ndarray, b: int) -> np.ndarray:
    """The 16-round TEA hash of uint32 pairs."""
    m = np.uint64(0xFFFFFFFF)
    v0 = a.astype(np.uint64) & m
    v1 = np.full_like(v0, np.uint64(b) & m)
    s = np.uint64(0)
    for _ in range(16):
        s = (s + np.uint64(0x9E3779B9)) & m
        v0 = (v0 + ((((v1 << np.uint64(4)) + np.uint64(0xA341316C)) & m)
                    ^ ((v1 + s) & m)
                    ^ (((v1 >> np.uint64(5)) + np.uint64(0xC8013EA4)) & m))) & m
        v1 = (v1 + ((((v0 << np.uint64(4)) + np.uint64(0xAD90777D)) & m)
                    ^ ((v0 + s) & m)
                    ^ (((v0 >> np.uint64(5)) + np.uint64(0x7E95761E)) & m))) & m
    return v0


def _next_uniform(seed: np.ndarray):
    """One step of the seed's integer hash → (uniform in [0, 1) as
    float32, next seed)."""
    m = np.uint64(0xFFFFFFFF)
    seed = (seed ^ np.uint64(61)) ^ (seed >> np.uint64(16))
    seed = (seed * np.uint64(9)) & m
    seed = seed ^ (seed >> np.uint64(4))
    seed = (seed * np.uint64(0x27D4EB2D)) & m
    seed = seed ^ (seed >> np.uint64(15))
    return (seed.astype(np.float32) / np.float32(4294967296.0)), seed


def pattern_uniforms(frame_index: int, salt: int):
    """The two uniforms of each of the 16 direction patterns of a
    frame → (r1, r2), float32 (16,)."""
    seed = _tea(np.arange(PATTERNS * PATTERNS, dtype=np.uint64)
                + np.uint64(salt), frame_index)
    r1, seed = _next_uniform(seed)
    r2, _ = _next_uniform(seed)
    return r1, r2


def cosine_direction(r1, r2, n):
    """A cosine-weighted direction about each unit normal ``n`` from the
    uniforms r1, r2, in the normal's frame (tangent from n x y, or
    n x x where the normal's x is within 0.1 of nought)."""
    r = torch.sqrt(r1)
    phi = 2.0 * PI * r2
    ey = torch.tensor([0.0, 1.0, 0.0], device=n.device).expand_as(n)
    ex = torch.tensor([1.0, 0.0, 0.0], device=n.device).expand_as(n)
    helper = torch.where((n[..., 0].abs() > 0.1).unsqueeze(-1), ey, ex)
    t = unit(cross(n, helper))
    b = cross(n, t)
    d = t * (r * torch.cos(phi)).unsqueeze(-1) \
        + b * (r * torch.sin(phi)).unsqueeze(-1) \
        + n * torch.sqrt(torch.clamp(1.0 - r1, min=0.0)).unsqueeze(-1)
    return unit(d)


def pattern_directions(frame_index: int, n, block: int, salt: int):
    """Each pixel's direction: the pattern of its (block x block) block,
    patterns tiled 4 x 4, about the pixel's normal ``n`` (H, W, 3)."""
    H, W = n.shape[:2]
    r1, r2 = (torch.as_tensor(x, device=n.device)
              for x in pattern_uniforms(frame_index, salt))
    py = (torch.arange(H, device=n.device) // block) % PATTERNS
    px = (torch.arange(W, device=n.device) // block) % PATTERNS
    idx = py[:, None] * PATTERNS + px[None, :]
    return cosine_direction(r1[idx], r2[idx], n)


def offset_origin(p, n):
    """Ray origins off a surface: each coordinate moved along the normal
    by 256 n integer steps of its float32 bits, or by n / 65536 within
    1/32 of nought."""
    steps = (256.0 * n).to(torch.int32)
    bits = p.contiguous().view(torch.int32)
    moved = (bits + torch.where(p < 0, -steps, steps)).view(torch.float32)
    return torch.where(p.abs() < 1.0 / 32.0, p + n / 65536.0, moved)


# --- materials ------------------------------------------------------------

def fresnel(spec, n, w):
    c = dot(n, w, keep=True)
    f = spec + (1.0 - spec) * torch.clamp(1.0 - c.abs(), 0.0, 1.0) ** 5
    return torch.where((spec != 0).any(-1, keepdim=True), f,
                       torch.zeros_like(f))


def _ggx(rough2, n, h):
    c = dot(n, h)
    a2 = rough2 * rough2
    den = c * c * (a2 - 1.0) + 1.0
    return torch.where(c > 0, a2 / (PI * den * den), torch.zeros_like(c))


def _smith1(rough2, n, h, w):
    c = dot(n, w)
    c2 = c * c
    a2 = rough2 * rough2
    g = 2.0 / (torch.sqrt(torch.clamp((a2 * (1.0 - c2) + c2)
                                      / torch.clamp(c2, min=1e-12),
                                      min=0.0)) + 1.0)
    return torch.where(c * dot(h, w) > 0, g, torch.zeros_like(g))


def brdf_cos(colour, rough2, metal, n, wo, wi):
    """Diffuse + GGX specular towards ``wo`` of light from ``wi``, times
    the cosine, for an index of refraction of 1.5 (reflectance 0.04) or
    the colour as the metal fraction goes; nought unless both lie on one
    side of ``n``."""
    m = metal.unsqueeze(-1)
    r0 = ((1.5 - 1.0) ** 2) / ((1.5 + 1.0) ** 2)
    spec = torch.full_like(colour, r0) + (colour - r0) * m
    up = torch.where(dot(n, wo, keep=True) <= 0, -n, n)
    h = unit(wi + wo)
    f_out = fresnel(spec, up, wo)
    f_h = fresnel(spec, h, wi)
    D = _ggx(rough2, up, h).unsqueeze(-1)
    G = (_smith1(rough2, up, h, wo) * _smith1(rough2, up, h, wi)).unsqueeze(-1)
    cos_i = dot(up, wi, keep=True).abs()
    diffuse = colour * (1.0 - m) * (1.0 - f_out) / PI
    specular = f_h * D * G / torch.clamp(
        4.0 * dot(up, wo, keep=True).abs() * cos_i, min=1e-8)
    out = (diffuse + specular) * cos_i
    same = (dot(n, wi) * dot(n, wo) > 0).unsqueeze(-1)
    return torch.where(same, out, torch.zeros_like(out))


def sky(d):
    """The procedural sky: horizon to zenith by the direction's height,
    and a sun glow about (1, 1, -1)."""
    t = (0.5 * (d[..., 1] + 1.0)).unsqueeze(-1)
    horizon = torch.tensor([0.4, 0.5, 0.6], device=d.device)
    zenith = torch.tensor([0.1, 0.2, 0.4], device=d.device)
    s = torch.tensor([1.0, 1.0, -1.0], device=d.device) / np.sqrt(3.0)
    glow = torch.clamp(dot(d, s.float().expand_as(d)), min=0.0) ** 128.0
    return horizon + (zenith - horizon) * t + glow.unsqueeze(-1) * 5.0


def texture_rgb(textures, tex_id, uv):
    """Bilinear texel colour at ``uv`` with repeat wrap, texel centres
    at half-integers; white where ``tex_id`` < 0."""
    data, sizes = textures
    N, S1, S2, _ = data.shape
    tid = torch.clamp(tex_id, min=0)
    h = sizes[tid, 0].float()
    w = sizes[tid, 1].float()
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0).unsqueeze(-1), (y - y0).unsqueeze(-1)
    flat = data.reshape(-1, 4)

    def texel(xi, yi):
        xi = torch.remainder(xi.long(), sizes[tid, 1])
        yi = torch.remainder(yi.long(), sizes[tid, 0])
        return flat[(tid * S1 + yi) * S2 + xi]

    top = texel(x0, y0) * (1 - fx) + texel(x0 + 1, y0) * fx
    bottom = texel(x0, y0 + 1) * (1 - fx) + texel(x0 + 1, y0 + 1) * fx
    rgb = (top * (1 - fy) + bottom * fy)[..., :3]
    return torch.where((tex_id >= 0).unsqueeze(-1), rgb, torch.ones_like(rgb))


def tone(c, exposure: float):
    return torch.pow(torch.clamp(c * exposure, min=0.0), 1.0 / 2.2)
