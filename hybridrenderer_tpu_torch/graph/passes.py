"""Render passes of the hybrid, forward and ray-traced paths as
functions over the graph registry (hybridrenderer_tpu/graph/passes.py).

Each ``make_*_pass(settings)`` returns (fn, reads, writes, history) for
``RenderGraph.add_pass``. ``ctx`` is the FrameContext below.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..core import maths
from ..core.types import DisplayMode, RenderFlags
from ..ops import composition as comp_ops
from ..ops import gbuffer as gbuffer_ops
from ..ops import postprocess as post_ops
from ..ops import raster as raster_ops
from ..ops import raster_cuda, shade, sky
from ..ops import svgf as svgf_ops
from ..ops import taa as taa_ops
from .params import RS, FrameState


@dataclasses.dataclass
class FrameContext:
    scene: Any
    cam: Any                 # CameraState of tensors on the scene device
    params: Any              # FrameParams
    settings: Any
    state: FrameState
    history_valid: bool      # False on the first frame after a reset
    shadow_query: Optional[Callable] = None  # (pos, n, dir, tmax) → vis
    # (origin, dir, ctx, depth, active) → (rgb, hit distance)
    trace_radiance: Optional[Callable] = None


def _clip_scene(settings, sc, cam, jitter_on, layers=(None,)):
    """Instance frustum cull, world → clip (jittered when ``jitter_on``),
    then near-plane clip and back-face cull of each layer: a triangle
    mask (T,) bool, None for all triangles → (culled instances (N,),
    [ClippedTriangles of the kept triangles of each layer])."""
    vp = cam.proj @ cam.view
    culled = maths.aabb_outside_frustum(
        sc.instances.aabb_min, sc.instances.aabb_max,
        maths.frustum_from_viewproj(vp))
    kept = ~culled[sc.triangles.instance.long()]
    jit2 = cam.jitter if jitter_on else None
    soup = sc.triangles
    corners = torch.stack([raster_ops.transform_to_clip(v, vp, jit2)
                           for v in (soup.v0, soup.v1, soup.v2)], dim=1)
    single = soup.single_sided if settings.raster_cull == "back" else None
    return culled, [raster_ops.clip_triangles(
        corners, settings.width, settings.height,
        kept if layer is None else kept & layer, single) for layer in layers]


def make_depth_prepass(settings):
    """DepthPrepass: the visibility raster without the attribute stage,
    for the ray-traced path: K1 vis-only, or K1v under raster_eval "v2" /
    "v3". Jittered under TAA only. Like the reference's prepass it draws
    no alpha test."""
    jitter_on = bool(settings.flags & RenderFlags.TAA)

    def fn(reg, ctx: FrameContext):
        _, (tris,) = _clip_scene(settings, ctx.scene, ctx.cam, jitter_on)
        vis, _ = raster_cuda.rasterize_binned(
            tris, settings.width, settings.height, None,
            vis_eval=settings.raster_eval)
        return {RS.DEPTH: vis.depth}

    return fn, (), (RS.DEPTH,), {}


def make_gbuffer_pass(settings):
    """GBufferPass: instance frustum cull, clip, binned tile raster with
    the attribute ride-along (kernel K1), then the G-buffer planes. The
    raster is jittered whenever TAA or SVGF is on.

    A scene with alpha-tested (cut-out) materials is rastered in two
    layers, as the reference does: K1 over the opaque triangles and K1
    over the cut-out ones; a cut-out winner is kept where its texel
    passes the alpha test and it lies in front of the opaque winner
    (reversed-Z: larger depth). One cut-out layer: a transparent texel
    in front of a second cut-out surface shows the opaque one behind."""
    jitter_on = bool(settings.flags & (RenderFlags.TAA | RenderFlags.SVGF))

    def fn(reg, ctx: FrameContext):
        sc, cam = ctx.scene, ctx.cam

        def raster(tris):
            return raster_cuda.rasterize_binned(
                tris, settings.width, settings.height, sc.raster_rows)

        if sc.has_alpha_test:
            mat = sc.instances.material[sc.triangles.instance.long()].long()
            tri_cut = (sc.materials.alpha_mode[mat] == 1) \
                & (sc.materials.colour_texture[mat] >= 0)
            culled, (opaque, cutout) = _clip_scene(
                settings, sc, cam, jitter_on, (~tri_cut, tri_cut))
            vis_op, attrs_op = raster(opaque)
            vis_cut, attrs_cut = raster(cutout)
            keep = (vis_cut.tri_id >= 0) \
                & gbuffer_ops.cutout_alpha_pass(sc, attrs_cut) \
                & (vis_cut.depth > vis_op.depth)
            vis = raster_ops.VisibilityBuffer(**{
                f: torch.where(keep, getattr(vis_cut, f), getattr(vis_op, f))
                for f in ("tri_id", "bary1", "bary2", "depth")})
            attrs = torch.where(keep.unsqueeze(-1), attrs_cut, attrs_op)
        else:
            culled, (tris,) = _clip_scene(settings, sc, cam, jitter_on)
            vis, attrs = raster(tris)
        gb = gbuffer_ops.build_gbuffer(vis, sc, cam, attrs)
        drawn = (~culled).sum()
        covered = (vis.tri_id >= 0).sum()
        stats = torch.stack([drawn, culled.shape[0] - drawn, covered])
        return {
            "_GBuffer": gb,
            "_FrameStats": stats,
            RS.ALBEDO: gb.albedo,
            RS.NORMAL: gb.normal,
            RS.MATERIAL_PARAMS: gb.material,
            RS.OBJECT_ID: gb.object_id,
            RS.MOTION: gb.motion_plane(),
            RS.EMISSIVE: gb.emissive,
            RS.DEPTH: gb.depth,
            RS.WORLD_POS: gb.world_pos,
        }

    writes = ("_GBuffer", "_FrameStats", RS.ALBEDO, RS.NORMAL,
              RS.MATERIAL_PARAMS, RS.OBJECT_ID, RS.MOTION, RS.EMISSIVE,
              RS.DEPTH, RS.WORLD_POS)
    history = {RS.NORMAL: RS.NORMAL, RS.OBJECT_ID: RS.OBJECT_ID,
               RS.MOTION: RS.MOTION, RS.DEPTH: RS.DEPTH}
    return fn, (), writes, history


def make_postprocess_pass(settings, input_name):
    def fn(reg, ctx: FrameContext):
        return {RS.RENDER_OUTPUT: post_ops.tonemap(reg[input_name][..., :3],
                                                   ctx.params.exposure)}

    return fn, (input_name,), (RS.RENDER_OUTPUT,), {}


def make_svgf_multi_pass(settings, chains):
    """All SVGF chains as one pass. ``chains``: [(SVGFConfig, input_name,
    output_name)]. History keys are '<prefix>' and '<prefix>Moments'."""

    def fn(reg, ctx: FrameContext):
        gb = reg["_GBuffer"]
        prev_normal = ctx.state.get(RS.NORMAL, gb.normal)
        prev_motion = ctx.state.get(RS.MOTION, gb.motion_plane())
        prev_oid = ctx.state.get(RS.OBJECT_ID, gb.object_id)
        H, W = settings.height, settings.width

        signals, histories, configs, all_ok = [], [], [], True
        for config, input_name, _ in chains:
            hist_sig = ctx.state.get(config.prefix)
            hist_mom = ctx.state.get(config.prefix + "Moments")
            if hist_sig is None or not ctx.history_valid:
                hist = svgf_ops.SVGFSignalHistory.create(H, W,
                                                         gb.depth.device)
                all_ok = False
            else:
                hist = svgf_ops.SVGFSignalHistory(signal=hist_sig,
                                                  moments=hist_mom)
            signal = reg[input_name]
            if signal.shape[-1] == 3:
                signal = torch.cat([signal, torch.ones_like(signal[..., :1])],
                                   dim=-1)
            signals.append(signal)
            histories.append(hist)
            configs.append(config)

        results = svgf_ops.denoise_multi(
            signals, gb.albedo, gb.motion_plane(), gb.normal, gb.object_id,
            histories, prev_normal, prev_motion[..., 2], prev_oid,
            configs, ctx.params.svgf_phi,
            history_valid=ctx.history_valid and all_ok)

        out = {}
        for (config, _, output_name), (res, new_hist, var_dbg) in zip(
                chains, results):
            out[output_name] = res
            out[config.prefix + "_HistSignal"] = new_hist.signal
            out[config.prefix + "_HistMoments"] = new_hist.moments
            out[config.prefix + "_Variance"] = var_dbg
        return out

    reads = tuple(dict.fromkeys([c[1] for c in chains] + ["_GBuffer"]))
    writes, history = [], {}
    for config, _, output_name in chains:
        writes += [output_name, config.prefix + "_HistSignal",
                   config.prefix + "_HistMoments",
                   config.prefix + "_Variance"]
        history[config.prefix + "_HistSignal"] = config.prefix
        history[config.prefix + "_HistMoments"] = config.prefix + "Moments"
    return fn, reads, tuple(writes), history


def make_composition_pass(settings, shadow_name, gi_name, refl_name,
                          variance_name=None):
    """CompositionPass. A signal whose pass is absent takes its neutral
    value: unshadowed with full AO, zero GI and zero reflection."""

    def fn(reg, ctx: FrameContext):
        gb = reg["_GBuffer"]
        H, W = gb.depth.shape
        dev = gb.depth.device
        shadow_ao = reg.get(shadow_name)
        shadow_ao = torch.ones((H, W, 2), device=dev) if shadow_ao is None \
            else shadow_ao[..., :2]
        zeros3 = torch.zeros((H, W, 3), device=dev)
        gi = reg.get(gi_name)
        gi = zeros3 if gi is None else gi[..., :3]
        refl = reg.get(refl_name)
        refl = zeros3 if refl is None else refl[..., :3]
        var = reg.get(variance_name) if variance_name else None
        out = comp_ops.compose(gb, shadow_ao, gi, refl, ctx.scene, ctx.cam,
                               settings, ctx.params, svgf_variance=var)
        return {RS.FINAL_COLOR: out}

    return fn, ("_GBuffer",), (RS.FINAL_COLOR,), {}


def make_forward_pass(settings):
    """ForwardPass (forward.frag): single-pass PBR over the G-buffer, the
    sun shadowed inline through the visibility hook when SHADOW is set,
    sky-based ambient with IBL, the debug display modes, and the sky (or
    black) behind the geometry."""

    def fn(reg, ctx: FrameContext):
        gb = reg["_GBuffer"]
        sc, cam, params = ctx.scene, ctx.cam, ctx.params
        flags = settings.flags
        bg = gb.background
        H, W = gb.depth.shape
        dev = gb.depth.device

        up = gb.normal.new_tensor([0.0, 1.0, 0.0]).expand_as(gb.normal)
        n = maths.normalize(torch.where(bg.unsqueeze(-1), up, gb.normal))
        v = maths.normalize(cam.position - gb.world_pos)
        l = maths.normalize(-params.sun_direction).expand_as(v)
        intensity = params.sun_color * params.sun_intensity \
            if flags & RenderFlags.LIGHT else torch.zeros(3, device=dev)

        if ctx.shadow_query is not None and flags & RenderFlags.SHADOW:
            shadow = ctx.shadow_query(gb.world_pos, n, l, 1000.0, active=~bg)
        else:
            shadow = torch.ones_like(gb.depth)

        rough = gb.material[..., 0]
        metal = gb.material[..., 1]
        direct = shade.eval_pbr(gb.albedo, 1.5, rough, metal, n, v, l) * \
            shadow.unsqueeze(-1) * intensity

        if flags & RenderFlags.IBL:
            r = maths.reflect(-v, n)
            env_spec = sky.sample_environment(r, sc.sky_texture, sc.textures,
                                              True, sc.has_sky_texture)
            env_diff = sky.sample_environment(n, sc.sky_texture, sc.textures,
                                              True, sc.has_sky_texture)
            f0 = maths.mix(torch.full_like(gb.albedo, 0.04), gb.albedo,
                           metal.unsqueeze(-1))
            f = shade.fresnel_schlick(f0, n, v)
            kd = (1.0 - f) * (1.0 - metal.unsqueeze(-1))
            ambient = (kd * env_diff * gb.albedo + f * env_spec) * \
                params.ambient_strength
        else:
            ambient = params.ambient_strength * gb.albedo

        color = ambient + direct + gb.emissive
        mode = settings.display_mode
        if mode == DisplayMode.ALBEDO:
            color = gb.albedo
        elif mode == DisplayMode.NORMAL:
            color = n * 0.5 + 0.5
        elif mode == DisplayMode.MATERIAL:
            color = torch.stack([rough, metal, torch.ones_like(rough)], -1)
        elif mode == DisplayMode.MOTION:
            color = torch.cat([torch.abs(gb.motion) * 100.0,
                               torch.zeros_like(gb.depth).unsqueeze(-1)], -1)
        elif mode == DisplayMode.DEPTH:
            color = gb.depth.unsqueeze(-1).expand(H, W, 3)

        sky_rgb = sky.sample_environment(
            comp_ops.view_directions(cam, H, W, dev), sc.sky_texture,
            sc.textures, bool(flags & RenderFlags.IBL), sc.has_sky_texture)
        return {RS.FINAL_COLOR: torch.where(bg.unsqueeze(-1), sky_rgb, color)}

    return fn, ("_GBuffer",), (RS.FINAL_COLOR,), {}


def make_skybox_pass(settings):
    """SkyboxPass: a fullscreen sky written into FinalColor, directions
    taken at the far plane; a demo pass no default path runs. With no
    sky texture it draws the procedural sky, as the reference does."""

    def fn(reg, ctx: FrameContext):
        H, W = settings.height, settings.width
        sc = ctx.scene
        rgb = sky.sample_environment(
            comp_ops.view_directions(ctx.cam, H, W, ctx.cam.position.device),
            sc.sky_texture, sc.textures,
            bool(settings.flags & RenderFlags.IBL), sc.has_sky_texture)
        return {RS.FINAL_COLOR: rgb}

    return fn, (), (RS.FINAL_COLOR,), {}


def make_taa_pass(settings, use_gbuffer: bool = True):
    """TAAPass (taa.comp) over the G-buffer's motion and depth, or with
    ``use_gbuffer=False`` over the named Motion and Depth resources (the
    ray-traced path: the primary pass's motion, the prepass's depth);
    the history fetch is kernel K5 (ops/taa.py). With no history yet it
    resolves against the current frame."""

    def fn(reg, ctx: FrameContext):
        if use_gbuffer:
            gb = reg["_GBuffer"]
            motion, depth = gb.motion, gb.depth
        else:
            motion, depth = reg[RS.MOTION][..., :2], reg[RS.DEPTH]
        history = reg.get("History_" + RS.TAA_OUTPUT)
        if history is None:
            history = reg[RS.FINAL_COLOR]
        out = taa_ops.resolve(
            reg[RS.FINAL_COLOR], history, motion, depth,
            ctx.cam.jitter, ctx.cam.prev_jitter,
            history_valid=ctx.history_valid,
            enabled=bool(settings.flags & RenderFlags.TAA))
        return {RS.TAA_OUTPUT: out}

    reads = (RS.FINAL_COLOR, "History_" + RS.TAA_OUTPUT) if use_gbuffer \
        else (RS.FINAL_COLOR, RS.MOTION, RS.DEPTH, "History_" + RS.TAA_OUTPUT)
    return fn, reads, (RS.TAA_OUTPUT,), {RS.TAA_OUTPUT: RS.TAA_OUTPUT}
