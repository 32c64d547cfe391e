"""Final lighting composition, linear-HDR output
(hybridrenderer_tpu/ops/composition.py)."""
from __future__ import annotations

import torch

from ..core import maths
from ..core.types import DisplayMode, RenderFlags
from . import image as img_ops
from . import shade, sky


def _gray(bg, value, out):
    return torch.where(bg.unsqueeze(-1), out.new_tensor(value).expand_as(out),
                       out)


def compose(gb, shadow_ao, gi, reflection, scene, cam, settings, params,
            svgf_variance=None):
    """G-buffer + (denoised) RT signals → linear HDR (H, W, 3).
    ``shadow_ao`` (H, W, 2+): R shadow factor, G ray-traced AO."""
    H, W = gb.depth.shape
    dev = gb.depth.device
    flags = settings.flags
    mode = settings.display_mode
    bg = gb.background

    # view direction through each pixel at the far plane (z_ndc = 0)
    uv = img_ops.pixel_uv_grid(H, W, dev)
    ndc = torch.cat([uv * 2.0 - 1.0, torch.zeros((H, W, 1), device=dev),
                     torch.ones((H, W, 1), device=dev)], dim=-1)
    world_h = ndc @ cam.view_proj_inverse.T
    hw = world_h[..., 3:4]
    far_point = world_h[..., :3] / torch.where(
        torch.abs(hw) < 1e-12, torch.full_like(hw, 1e-12), hw)
    view_dir = maths.normalize(far_point - cam.position)
    sky_rgb = sky.sample_environment(
        view_dir, ibl_enabled=bool(flags & RenderFlags.IBL),
        has_sky=scene.has_sky_texture)

    zeros3 = torch.zeros((H, W, 3), device=dev)
    if mode == DisplayMode.ALBEDO:
        return torch.where(bg.unsqueeze(-1), zeros3, gb.albedo)
    if mode == DisplayMode.NORMAL:
        return _gray(bg, [0.15, 0.15, 0.15], gb.normal * 0.5 + 0.5)
    if mode == DisplayMode.MATERIAL:
        return _gray(bg, [0.15, 0.15, 0.15], gb.material[..., :3])
    if mode == DisplayMode.DEPTH:
        v = 1.0 / (gb.linear_depth * 0.1 + 1.0)
        return torch.where(bg.unsqueeze(-1), zeros3,
                           v.unsqueeze(-1).expand(H, W, 3))
    if mode == DisplayMode.MOTION:
        return torch.cat([torch.abs(gb.motion) * 10.0,
                          torch.zeros((H, W, 1), device=dev)], dim=-1)
    if mode == DisplayMode.SHADOW:
        return shadow_ao[..., 0:1].expand(H, W, 3)
    if mode == DisplayMode.AO:
        return shadow_ao[..., 1:2].expand(H, W, 3)
    if mode == DisplayMode.GI:
        return gi
    if mode == DisplayMode.REFLECTION:
        return reflection
    if mode == DisplayMode.EMISSIVE:
        return gb.emissive
    if mode == DisplayMode.SVGF_VARIANCE and svgf_variance is not None:
        return svgf_variance.unsqueeze(-1).expand(H, W, 3)

    base = gb.albedo
    up = gb.normal.new_tensor([0.0, 1.0, 0.0]).expand_as(gb.normal)
    n = maths.normalize(torch.where(bg.unsqueeze(-1), up, gb.normal))
    rough = gb.material[..., 0]
    metal = gb.material[..., 1]
    v = maths.normalize(cam.position - gb.world_pos)
    l = maths.normalize(-params.sun_direction).expand_as(v)

    if flags & RenderFlags.LIGHT:
        intensity = params.sun_color * params.sun_intensity
    else:
        intensity = torch.zeros(3, device=dev)

    shadow = shadow_ao[..., 0]
    rt_ao = shadow_ao[..., 1]
    direct = shade.eval_pbr(base, 1.5, rough, metal, n, v, l) * \
        shadow.unsqueeze(-1) * intensity

    f0 = maths.mix(torch.full_like(base, 0.04), base, metal.unsqueeze(-1))
    f = shade.fresnel_schlick(f0, n, v)
    kd = (1.0 - f) * (1.0 - metal.unsqueeze(-1))
    if flags & RenderFlags.GI:
        indirect_diffuse = gi * base * kd
    else:
        indirect_diffuse = params.ambient_strength * base * \
            rt_ao.unsqueeze(-1) * 0.1
    indirect_specular = reflection * f

    out = direct + indirect_diffuse + indirect_specular + gb.emissive
    return torch.where(bg.unsqueeze(-1), sky_rgb, out)
