"""Ray-tracing passes over the frame context's trace hooks
(hybridrenderer_tpu/graph/rt_passes.py): RTShadowPass (unfused),
RTReflectionPass and RTDiffuseGIPass. The primary-ray pass of the
ray-traced path is not ported yet."""
from __future__ import annotations

import torch

from ..core import maths
from ..core.types import RenderFlags
from ..ops import image as img_ops
from ..ops import sampling
from .params import RS

GI_SALT = 0x7D1E6100   # decorrelates the GI pattern draws from AO's


def _reconstruct_dirs(gb, cam):
    return maths.normalize(gb.world_pos - cam.position)


def make_rt_shadow_pass(settings):
    """RTShadowPass: packed (shadow, AO, 0, 1) 1-spp signal from NEE light
    sampling (the sun when the scene has no emissive light) and a
    cosine-hemisphere AO ray, both through the any-hit query (K2)."""

    def fn(reg, ctx):
        gb = reg["_GBuffer"]
        H, W = gb.depth.shape
        dev = gb.depth.device
        if ctx.shadow_query is None:
            out = torch.ones((H, W, 4), device=dev)
            out[..., 2] = 0.0
            return {RS.CUR_COLOR: out}

        sc, params = ctx.scene, ctx.params
        n = gb.normal
        bg = gb.background
        # per-pixel seeds, only where a draw uses them: the light sample
        # of a scene with emissive lights, or per-pixel TEA AO. The jitted
        # reference drops the unused hash; eagerly it is ~200 launches.
        seed = None
        if (settings.flags & RenderFlags.SHADOW and sc.lights.count > 0) or (
                settings.flags & RenderFlags.AO and not settings.ao_interleaved
                and not settings.use_blue_noise):
            pixel_idx = torch.arange(H * W, dtype=torch.int64,
                                     device=dev).reshape(H, W)
            seed = sampling.init_random_seed(pixel_idx, params.frame_index)

        shadow = torch.ones((H, W), device=dev)
        if settings.flags & RenderFlags.SHADOW:
            ldir, _, seed = sampling.sample_lights(sc, gb.world_pos, seed)
            has_area = (maths.length(ldir) > 0.01).unsqueeze(-1)
            sun_dir = maths.normalize(-params.sun_direction).expand_as(ldir)
            l = torch.where(has_area, ldir, sun_dir)
            shadow = ctx.shadow_query(gb.world_pos, n, l, 1e10, active=~bg)

        ao = torch.ones((H, W), device=dev)
        if settings.flags & RenderFlags.AO:
            if settings.ao_interleaved:
                ao_dir = sampling.interleaved_cos_hemisphere(
                    params.frame_index, n, block=settings.ao_block)
            elif settings.use_blue_noise:
                bn = sampling.blue_noise_uniforms(
                    sc.blue_noise, params.frame_index, H, W)
                ao_dir = sampling.cos_hemisphere_from_uniforms(
                    bn[..., 0], bn[..., 1], n)
            else:
                # continues the light-sampling seed stream
                ao_dir, _ = sampling.cos_hemisphere_sample(seed, n)
            ao = ctx.shadow_query(gb.world_pos, n, ao_dir,
                                  settings.ao_radius, active=~bg)

        one = torch.ones_like(ao)
        shadow = torch.where(bg, one, shadow)
        ao = torch.where(bg, one, ao)
        return {RS.CUR_COLOR: torch.stack(
            [shadow, ao, torch.zeros_like(ao), one], dim=-1)}

    return fn, ("_GBuffer",), (RS.CUR_COLOR,), {}


def make_rt_reflection_pass(settings):
    """RTReflectionPass (reflection.rgen): mirror rays from pixels whose
    roughness is at most the cutoff, shaded by the closest-hit radiance
    hook (K2c); the others trace nothing and get zero."""

    def fn(reg, ctx):
        gb = reg["_GBuffer"]
        H, W = gb.depth.shape
        dev = gb.depth.device
        if ctx.trace_radiance is None:
            return {RS.REFLECTION_RAW: torch.zeros((H, W, 4), device=dev)}

        n = gb.normal
        refl_dir = maths.reflect(_reconstruct_dirs(gb, ctx.cam), n)
        origin = sampling.offset_ray(gb.world_pos, n)
        cut = (gb.material[..., 0] > settings.reflection_roughness_cutoff) \
            | gb.background
        if settings.reflection_half_res:
            rad_h, _ = ctx.trace_radiance(origin[::2, ::2],
                                          refl_dir[::2, ::2], ctx, 0,
                                          active=~cut[::2, ::2])
            radiance = img_ops.upsample2x_depth_aware(
                rad_h, gb.linear_depth[::2, ::2], gb.linear_depth)
        else:
            radiance, _ = ctx.trace_radiance(origin, refl_dir, ctx, 0,
                                             active=~cut)
        rgb = torch.where(cut.unsqueeze(-1), torch.zeros_like(radiance),
                          radiance)
        return {RS.REFLECTION_RAW: torch.cat(
            [rgb, torch.ones((H, W, 1), device=dev)], dim=-1)}

    return fn, ("_GBuffer",), (RS.REFLECTION_RAW,), {}


def make_rt_gi_pass(settings):
    """RTDiffuseGIPass (diffuse_gi.rgen): one 1-spp cosine-hemisphere
    bounce per covered pixel through the radiance hook (K2c). Directions
    are drawn per interleave pattern (the AO sampler, salted), else per
    pixel from blue noise (zw channels) or the TEA hash."""

    def fn(reg, ctx):
        gb = reg["_GBuffer"]
        H, W = gb.depth.shape
        dev = gb.depth.device
        if ctx.trace_radiance is None:
            return {RS.GI_RAW: torch.zeros((H, W, 4), device=dev)}
        params = ctx.params

        def trace_gi(nrm, wpos, bgm, hh, ww, block):
            if settings.gi_interleaved:
                ray_dir = sampling.interleaved_cos_hemisphere(
                    params.frame_index, nrm, block=block, salt=GI_SALT)
            elif settings.use_blue_noise:
                bn = sampling.blue_noise_uniforms(
                    ctx.scene.blue_noise, params.frame_index, hh, ww)
                ray_dir = sampling.cos_hemisphere_from_uniforms(
                    bn[..., 2], bn[..., 3], nrm)
            else:
                pixel_idx = torch.arange(hh * ww, dtype=torch.int64,
                                         device=dev).reshape(hh, ww)
                seed = sampling.init_random_seed(pixel_idx,
                                                 params.frame_index)
                ray_dir, _ = sampling.cos_hemisphere_sample(seed, nrm)
            origin = sampling.offset_ray(wpos, nrm)
            rad, _ = ctx.trace_radiance(origin, ray_dir, ctx, 0,
                                        active=~bgm)
            return rad

        if settings.gi_half_res:
            # half the interleave block, so each direction block covers
            # the same screen area as at full res
            rad_h = trace_gi(gb.normal[::2, ::2], gb.world_pos[::2, ::2],
                             gb.background[::2, ::2], (H + 1) // 2,
                             (W + 1) // 2, max(settings.gi_block // 2, 2))
            radiance = img_ops.upsample2x_depth_aware(
                rad_h, gb.linear_depth[::2, ::2], gb.linear_depth)
        else:
            radiance = trace_gi(gb.normal, gb.world_pos, gb.background, H, W,
                                settings.gi_block)
        rgb = torch.where(gb.background.unsqueeze(-1),
                          torch.zeros_like(radiance), radiance)
        return {RS.GI_RAW: torch.cat(
            [rgb, torch.ones((H, W, 1), device=dev)], dim=-1)}

    return fn, ("_GBuffer",), (RS.GI_RAW,), {}
