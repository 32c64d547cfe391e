"""Texture sampling over the bindless TextureStack
(hybridrenderer_tpu/ops/texture.py).

Bilinear filtering with REPEAT wrap by each texture's true size, as four
gathers from the padded (N, H, W, 4) stack. The reference's quad-texel
layout (``sample_bilinear_quad``) bakes the same four taps into one row
for its TPU's gathers and gives the same bits; its per-lane table
replication (``spread_gather``) is plain indexing here. Weights stay
float32: the card's hardware filtering (1.8 fixed-point weights) would
not match the reference.
"""
from __future__ import annotations

import torch

from ..core import maths


def has_textures(textures) -> bool:
    """The empty TextureStack placeholder is (1, 1, 1, 4)."""
    return textures.data.shape[1] > 1 or textures.data.shape[2] > 1


def _default(default, out):
    return maths.constant(tuple(float(x) for x in default),
                          out.device).expand_as(out)


def _texels(stack_data):
    """The (N, TH, TW, 4) f32 stack as one 16-byte complex128 element a
    texel, so that a tap is a 1-D gather of one element a pixel: PyTorch
    gathers 16-byte rows of a 2-D table on the card with a thread block
    a row, five times slower for the whole 1080p sample on an H100
    (chip_smoke.py's sampler check). The values are moved, never
    computed, so the bits are the texels'."""
    flat = stack_data.reshape(-1, 4)
    if flat.data_ptr() % 16:
        flat = flat.clone()
    return flat.view(torch.complex128)[:, 0]


def sample_bilinear(stack_data, stack_sizes, tex_id, uv, default):
    """Bilinear sample; ``default`` where ``tex_id`` < 0.

    stack_data (N, TH, TW, 4) f32, stack_sizes (N, 2) i32 (height, width)
    in use, tex_id (...) i32, uv (..., 2) f32 → (..., 4) f32. The
    arithmetic is the reference's, operation for operation: the wrap is
    a floor modulo (the divisor's sign), so negative UVs and UVs above 1
    repeat."""
    tid = torch.clamp(tex_id, min=0).long()
    hw = stack_sizes.to(torch.float32)[tid]
    h, w = hw[..., 0], hw[..., 1]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0).unsqueeze(-1)
    fy = (y - y0).unsqueeze(-1)
    N, TH, TW, _ = stack_data.shape
    texels = _texels(stack_data)
    wi, hi = w.to(torch.int32), h.to(torch.int32)

    def tap(xf, yf):
        xi = torch.remainder(xf.to(torch.int32), wi)
        yi = torch.remainder(yf.to(torch.int32), hi)
        rgba = texels[(tid * TH + yi) * TW + xi]
        return rgba.view(torch.float32).reshape(*tid.shape, 4)

    c00 = tap(x0, y0)
    c10 = tap(x0 + 1, y0)
    c01 = tap(x0, y0 + 1)
    c11 = tap(x0 + 1, y0 + 1)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    out = top * (1 - fy) + bot * fy
    return torch.where((tex_id >= 0).unsqueeze(-1), out, _default(default,
                                                                  out))


def sample_stack(textures, tex_id, uv, default):
    """Bilinear sample of a TextureStack (``sample_bilinear``)."""
    return sample_bilinear(textures.data, textures.sizes, tex_id, uv, default)
