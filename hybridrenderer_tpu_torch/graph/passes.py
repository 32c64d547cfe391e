"""Render passes of the hybrid path as functions over the graph registry
(hybridrenderer_tpu/graph/passes.py).

Each ``make_*_pass(settings)`` returns (fn, reads, writes, history) for
``RenderGraph.add_pass``. ``ctx`` is the FrameContext below.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..core import maths
from ..core.types import RenderFlags
from ..ops import composition as comp_ops
from ..ops import gbuffer as gbuffer_ops
from ..ops import postprocess as post_ops
from ..ops import raster as raster_ops
from ..ops import raster_cuda
from ..ops import svgf as svgf_ops
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


def make_gbuffer_pass(settings):
    """GBufferPass: instance frustum cull, clip, binned tile raster with
    the attribute ride-along (kernel K1), then the G-buffer planes. The
    raster is jittered whenever TAA or SVGF is on."""
    jitter_on = bool(settings.flags & (RenderFlags.TAA | RenderFlags.SVGF))

    def fn(reg, ctx: FrameContext):
        sc, cam = ctx.scene, ctx.cam
        if sc.has_alpha_test:
            raise NotImplementedError(
                "the alpha-tested G-buffer layer is not ported yet")
        vp = cam.proj @ cam.view
        culled = maths.aabb_outside_frustum(
            sc.instances.aabb_min, sc.instances.aabb_max,
            maths.frustum_from_viewproj(vp))
        tri_mask = ~culled[sc.triangles.instance.long()]
        jit2 = cam.jitter if jitter_on else None
        soup = sc.triangles
        corners = torch.stack(
            [raster_ops.transform_to_clip(v, vp, jit2)
             for v in (soup.v0, soup.v1, soup.v2)], dim=1)
        single = soup.single_sided if settings.raster_cull == "back" else None
        tris = raster_ops.clip_triangles(corners, settings.width,
                                         settings.height, tri_mask, single)
        vis, attrs = raster_cuda.rasterize_binned(
            tris, settings.width, settings.height, sc.raster_rows)
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


def make_composition_pass(settings, shadow_name, variance_name=None):
    """CompositionPass. Reflection and GI are not on this path; their
    inputs are the neutral zero signals."""

    def fn(reg, ctx: FrameContext):
        gb = reg["_GBuffer"]
        H, W = gb.depth.shape
        dev = gb.depth.device
        shadow_ao = reg.get(shadow_name)
        shadow_ao = torch.ones((H, W, 2), device=dev) if shadow_ao is None \
            else shadow_ao[..., :2]
        zeros3 = torch.zeros((H, W, 3), device=dev)
        var = reg.get(variance_name) if variance_name else None
        out = comp_ops.compose(gb, shadow_ao, zeros3, zeros3, ctx.scene,
                               ctx.cam, settings, ctx.params,
                               svgf_variance=var)
        return {RS.FINAL_COLOR: out}

    return fn, ("_GBuffer",), (RS.FINAL_COLOR,), {}
