"""Hybrid render path (hybridrenderer_tpu/paths/hybrid.py):

GBuffer → RT shadow + AO → SVGF (one ShadowAO chain) → Composition →
PostProcess. The reference's hybrid path has no TAA pass; neither has
this one. Reflection and diffuse GI are not ported yet: asking for them
raises.
"""
from __future__ import annotations

from ..core.types import RenderFlags
from ..graph import passes, rt_passes
from ..graph.params import RS
from ..ops.svgf import SVGFConfig
from .base import RenderPath


class HybridRenderPath(RenderPath):
    kind = "hybrid"

    def build_graph(self, graph):
        s = self.settings
        f = s.flags
        if f & (RenderFlags.REFLECTION | RenderFlags.GI):
            raise NotImplementedError(
                "ray-traced reflections and diffuse GI are not ported yet")
        self.add(graph, "GBufferPass", passes.make_gbuffer_pass(s), "graphics")

        shadow_name = variance_name = None
        if f & (RenderFlags.SHADOW | RenderFlags.AO):
            self.add(graph, "RTShadowPass", rt_passes.make_rt_shadow_pass(s),
                     "raytracing")
            shadow_name = RS.CUR_COLOR

        temporal = bool(f & RenderFlags.SVGF_TEMPORAL)
        spatial = bool(f & RenderFlags.SVGF_SPATIAL)
        if shadow_name and f & RenderFlags.SVGF and (temporal or spatial):
            cfg = SVGFConfig(prefix="SVGF_ShadowAO",
                             atrous_iterations=s.svgf_atrous_iterations,
                             temporal_enabled=temporal,
                             spatial_enabled=spatial,
                             use_albedo_demod=False, bits=s.svgf_bits)
            chains = [(cfg, shadow_name, "ShadowAO_Denoised")]
            shadow_name = "ShadowAO_Denoised"
            variance_name = "SVGF_ShadowAO_Variance"
            self.add(graph, "SVGFPass",
                     passes.make_svgf_multi_pass(s, chains), "compute")

        self.add(graph, "CompositionPass",
                 passes.make_composition_pass(s, shadow_name or "__none__",
                                              variance_name), "graphics")
        self.add(graph, "PostProcessPass",
                 passes.make_postprocess_pass(s, RS.FINAL_COLOR), "graphics")
