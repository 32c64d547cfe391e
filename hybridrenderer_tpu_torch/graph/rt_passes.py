"""Ray-tracing passes over the frame context's trace hooks
(hybridrenderer_tpu/graph/rt_passes.py): RTShadowPass (fused or not),
RTReflectionPass, RTDiffuseGIPass, the ray-traced path's RaytracePass
(primary rays), and the reference's two demo passes that no path runs,
RTAOPass and RayQueryPass.

In a row window (a row-sharded frame's shard) every pattern and seed
follows the image pixel: the per-pixel TEA seeds, the interleaved AO /
GI pattern, the blue-noise offset and the NEE seeds of traced rays; the
half-res grids keep the whole image's even rows."""
from __future__ import annotations

import torch

from ..core import maths
from ..core.types import RenderFlags
from ..ops import composition as comp_ops
from ..ops import image as img_ops
from ..ops import sampling, shade, sky
from .params import RS

GI_SALT = 0x7D1E6100   # decorrelates the GI pattern draws from AO's


def _reconstruct_dirs(gb, cam):
    return maths.normalize(gb.world_pos - cam.position)


def _half_rows(ctx):
    """The window's rows on the half-res grid (the image's even rows) →
    (first local row, first half-res image row)."""
    first = ctx.row0 % 2
    return first, (ctx.row0 + first) // 2


def _upsample(ctx, rad_h, gb, first_half):
    """The half-res signal of the window's half-res rows (first image
    half row ``first_half``) → full res over the window's rows, with the
    one halo half row the upsample reads."""
    z_half = gb.linear_depth[ctx.row0 % 2::2, ::2]
    (rad_p, z_p), top = ctx.halo(1, rad_h, z_half)
    return img_ops.upsample2x_depth_aware(
        rad_p, z_p, gb.linear_depth, row0=ctx.row0,
        half_row0=first_half - top, full_height=ctx.image_height)


def make_rt_shadow_pass(settings):
    """RTShadowPass: packed (shadow, AO, 0, 1) 1-spp signal from NEE light
    sampling (the sun when the scene has no emissive light) and a
    cosine-hemisphere AO ray, both through the any-hit query (K2). Under
    ``fuse_shadow_ao``, with SHADOW, interleaved AO and the pair hook,
    both queries go out in one launch (``shadow_query_pair``), as the
    reference's RT_FUSE_SHADOW_AO branch: the same signal."""

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
            pixel_idx = sampling.pixel_index(H, W, dev, ctx.row0)
            seed = sampling.init_random_seed(pixel_idx, params.frame_index)

        shadow = torch.ones((H, W), device=dev)
        l = None
        if settings.flags & RenderFlags.SHADOW:
            ldir, _, seed = sampling.sample_lights(sc, gb.world_pos, seed)
            has_area = (maths.length(ldir) > 0.01).unsqueeze(-1)
            sun_dir = maths.normalize(-params.sun_direction).expand_as(ldir)
            l = torch.where(has_area, ldir, sun_dir)

        ao = torch.ones((H, W), device=dev)
        fuse = (settings.fuse_shadow_ao and l is not None
                and settings.flags & RenderFlags.AO
                and settings.ao_interleaved
                and ctx.shadow_query_pair is not None)
        if fuse:
            ao_dir = sampling.interleaved_cos_hemisphere(
                params.frame_index, n, block=settings.ao_block,
                row0=ctx.row0)
            shadow, ao = ctx.shadow_query_pair(
                gb.world_pos, n, l, 1e10, ao_dir, settings.ao_radius,
                active=~bg)
        elif l is not None:
            shadow = ctx.shadow_query(gb.world_pos, n, l, 1e10, active=~bg)

        if settings.flags & RenderFlags.AO and not fuse:
            if settings.ao_interleaved:
                ao_dir = sampling.interleaved_cos_hemisphere(
                    params.frame_index, n, block=settings.ao_block,
                    row0=ctx.row0)
            elif settings.use_blue_noise:
                bn = sampling.blue_noise_uniforms(
                    sc.blue_noise, params.frame_index, H, W, ctx.row0)
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
            s, first_half = _half_rows(ctx)
            rad_h, _ = ctx.trace_radiance(origin[s::2, ::2],
                                          refl_dir[s::2, ::2], ctx, 0,
                                          active=~cut[s::2, ::2],
                                          row0=first_half)
            radiance = _upsample(ctx, rad_h, gb, first_half)
        else:
            radiance, _ = ctx.trace_radiance(origin, refl_dir, ctx, 0,
                                             active=~cut, row0=ctx.row0)
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

        def trace_gi(nrm, wpos, bgm, block, row0):
            hh, ww = nrm.shape[:2]
            if settings.gi_interleaved:
                ray_dir = sampling.interleaved_cos_hemisphere(
                    params.frame_index, nrm, block=block, salt=GI_SALT,
                    row0=row0)
            elif settings.use_blue_noise:
                bn = sampling.blue_noise_uniforms(
                    ctx.scene.blue_noise, params.frame_index, hh, ww, row0)
                ray_dir = sampling.cos_hemisphere_from_uniforms(
                    bn[..., 2], bn[..., 3], nrm)
            else:
                pixel_idx = sampling.pixel_index(hh, ww, dev, row0)
                seed = sampling.init_random_seed(pixel_idx,
                                                 params.frame_index)
                ray_dir, _ = sampling.cos_hemisphere_sample(seed, nrm)
            origin = sampling.offset_ray(wpos, nrm)
            rad, _ = ctx.trace_radiance(origin, ray_dir, ctx, 0,
                                        active=~bgm, row0=row0)
            return rad

        if settings.gi_half_res:
            # half the interleave block, so each direction block covers
            # the same screen area as at full res
            s, first_half = _half_rows(ctx)
            rad_h = trace_gi(gb.normal[s::2, ::2], gb.world_pos[s::2, ::2],
                             gb.background[s::2, ::2],
                             max(settings.gi_block // 2, 2), first_half)
            radiance = _upsample(ctx, rad_h, gb, first_half)
        else:
            radiance = trace_gi(gb.normal, gb.world_pos, gb.background,
                                settings.gi_block, ctx.row0)
        rgb = torch.where(gb.background.unsqueeze(-1),
                          torch.zeros_like(radiance), radiance)
        return {RS.GI_RAW: torch.cat(
            [rgb, torch.ones((H, W, 1), device=dev)], dim=-1)}

    return fn, ("_GBuffer",), (RS.GI_RAW,), {}


def make_primary_rt_pass(settings):
    """RaytracePass (raytrace.rgen): primary camera rays through the
    radiance hook → FinalColor and Motion (uv motion, linear distance,
    0). Motion reprojects the hit point with the previous camera only,
    as the reference does (object motion is not reconstructed).

    A reference defect is matched on purpose: the reference tests for a
    hit with isfinite(dist), but a miss reports dist -1, which is finite.
    So a sky pixel counts as a hit at distance -1: its motion is that of
    the point one unit behind the camera, and its linear depth is -1."""

    def fn(reg, ctx):
        H, W = settings.height, settings.width
        cam = ctx.cam
        dev = cam.position.device
        direction = comp_ops.view_directions(cam, H, W, dev, ctx.row0,
                                             ctx.image_height)
        origin = cam.position.expand(H, W, 3)
        if ctx.trace_radiance is None:
            sc = ctx.scene
            rgb = sky.sample_environment(
                direction, sc.sky_texture, sc.textures,
                bool(settings.flags & RenderFlags.IBL),
                has_sky=sc.has_sky_texture)
            return {RS.FINAL_COLOR: rgb,
                    RS.MOTION: torch.zeros((H, W, 4), device=dev)}
        rgb, dist = ctx.trace_radiance(origin, direction, ctx, 0,
                                       row0=ctx.row0)
        hit = torch.isfinite(dist)        # the reference's test, see above
        d_safe = torch.where(hit, dist, torch.ones_like(dist)).unsqueeze(-1)
        world = origin + direction * d_safe
        prev_vp = cam.prev_proj @ cam.prev_view
        cur_vp = cam.proj @ cam.view

        def to_uv(clip):
            w = clip[..., 3:4]
            w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
            return (clip[..., :2] / w) * 0.5 + 0.5

        mv = to_uv(maths.transform_point_h(cur_vp, world)) \
            - to_uv(maths.transform_point_h(prev_vp, world))
        lin_z = torch.where(hit, dist, torch.zeros_like(dist))
        motion = torch.cat([torch.where(hit.unsqueeze(-1), mv,
                                        torch.zeros_like(mv)),
                            lin_z.unsqueeze(-1),
                            torch.zeros((H, W, 1), device=dev)], dim=-1)
        return {RS.FINAL_COLOR: rgb, RS.MOTION: motion}

    return fn, (), (RS.FINAL_COLOR, RS.MOTION), {}


def make_rtao_pass(settings):
    """RTAOPass (rt_ao.rgen): the reference's AO-only demo, which no path
    runs. One cosine-hemisphere ray per covered pixel from the TEA seed
    stream, to 2 units, through the visibility hook; background 1.0."""

    def fn(reg, ctx):
        gb = reg["_GBuffer"]
        H, W = gb.depth.shape
        dev = gb.depth.device
        ao = torch.ones((H, W), device=dev)
        if ctx.shadow_query is not None:
            pixel_idx = sampling.pixel_index(H, W, dev, ctx.row0)
            seed = sampling.init_random_seed(pixel_idx,
                                             ctx.params.frame_index)
            ao_dir, _ = sampling.cos_hemisphere_sample(seed, gb.normal)
            ao = ctx.shadow_query(gb.world_pos, gb.normal, ao_dir, 2.0,
                                  active=~gb.background)
            ao = torch.where(gb.background, torch.ones_like(ao), ao)
        zeros = torch.zeros_like(ao)
        return {RS.AO_RAW: torch.stack([ao, zeros, zeros,
                                        torch.ones_like(ao)], dim=-1)}

    return fn, ("_GBuffer",), (RS.AO_RAW,), {}


def make_rayquery_pass(settings):
    """RayQueryPass (rayquery.frag): the reference's forward raster +
    per-fragment ray-query shadow demo, which no path runs, over the
    G-buffer. Its differences from ForwardPass are kept: the shadow ray
    leaves along the screen-space face normal, runs to 10000, and is
    traced whenever a tracer is attached; ambient is IBL only with a sky
    texture; the background is black."""

    def fn(reg, ctx):
        gb = reg["_GBuffer"]
        sc, cam, params = ctx.scene, ctx.cam, ctx.params
        bg = gb.background
        up = maths.constant((0.0, 1.0, 0.0), gb.normal.device) \
            .expand_as(gb.normal)
        n = maths.normalize(torch.where(bg.unsqueeze(-1), up, gb.normal))
        v = maths.normalize(cam.position - gb.world_pos)
        l = maths.normalize(-params.sun_direction).expand_as(v)
        intensity = params.sun_color * params.sun_intensity

        # dFdx / dFdy face normal of the deferred fragment
        wp = gb.world_pos
        ddx = torch.diff(wp, dim=1, append=wp[:, -1:])
        ddy = ctx.windowed(1, lambda _, w: torch.diff(w, dim=0,
                                                      append=w[-1:, :]), wp)
        face_n = maths.normalize(maths.cross(ddx, ddy))
        flip = maths.dot(face_n, v, keepdim=True) < 0.0
        face_n = torch.where(flip, -face_n, face_n)

        shadow = torch.ones_like(gb.depth)
        if ctx.shadow_query is not None:
            shadow = ctx.shadow_query(wp, face_n, l, 10000.0, active=~bg)

        rough = gb.material[..., 0]
        metal = gb.material[..., 1]
        direct = shade.eval_pbr(gb.albedo, 1.5, rough, metal, n, v, l) \
            * shadow.unsqueeze(-1) * intensity
        if sc.has_sky_texture:
            r = maths.reflect(-v, n)
            env_spec = sky.sample_environment(r, sc.sky_texture, sc.textures,
                                              True, sc.has_sky_texture)
            env_diff = sky.sample_environment(n, sc.sky_texture, sc.textures,
                                              True, sc.has_sky_texture)
            f0 = maths.mix(torch.full_like(gb.albedo, 0.04), gb.albedo,
                           metal.unsqueeze(-1))
            f = shade.fresnel_schlick(f0, n, v)
            kd = (1.0 - f) * (1.0 - metal.unsqueeze(-1))
            ambient = (kd * env_diff * gb.albedo + f * env_spec) \
                * params.ambient_strength
        else:
            ambient = params.ambient_strength * gb.albedo
        color = ambient + direct + gb.emissive
        return {RS.FINAL_COLOR: torch.where(bg.unsqueeze(-1),
                                            torch.zeros_like(color), color)}

    return fn, ("_GBuffer",), (RS.FINAL_COLOR,), {}
