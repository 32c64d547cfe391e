"""Ray-tracing passes over the frame context's visibility hook
(hybridrenderer_tpu/graph/rt_passes.py): RTShadowPass, unfused. The
reflection, GI and primary-ray passes are not ported yet."""
from __future__ import annotations

import torch

from ..core import maths
from ..core.types import RenderFlags
from ..ops import sampling
from .params import RS


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
