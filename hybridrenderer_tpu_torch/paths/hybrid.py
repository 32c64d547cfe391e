"""Hybrid render path (hybridrenderer_tpu/paths/hybrid.py):

GBuffer → [RT shadow + AO / reflections / diffuse GI] → [SVGF, one chain
per signal] → Composition → PostProcess. The reference's hybrid path has
no TAA pass; neither has this one.
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
        self.add(graph, "GBufferPass", passes.make_gbuffer_pass(s), "graphics")

        shadow_name = gi_name = refl_name = variance_name = None
        if f & (RenderFlags.SHADOW | RenderFlags.AO):
            self.add(graph, "RTShadowPass", rt_passes.make_rt_shadow_pass(s),
                     "raytracing")
            shadow_name = RS.CUR_COLOR
        if f & RenderFlags.REFLECTION:
            self.add(graph, "RTReflectionPass",
                     rt_passes.make_rt_reflection_pass(s), "raytracing")
            refl_name = RS.REFLECTION_RAW
        if f & RenderFlags.GI:
            self.add(graph, "RTDiffuseGIPass", rt_passes.make_rt_gi_pass(s),
                     "raytracing")
            gi_name = RS.GI_RAW

        # SVGF chains: ShadowAO as it is, reflection and GI demodulated by
        # albedo, all in one pass
        temporal = bool(f & RenderFlags.SVGF_TEMPORAL)
        spatial = bool(f & RenderFlags.SVGF_SPATIAL)
        chains = []
        if f & RenderFlags.SVGF and (temporal or spatial):
            def cfg(prefix, demod):
                return SVGFConfig(prefix=prefix,
                                  atrous_iterations=s.svgf_atrous_iterations,
                                  temporal_enabled=temporal,
                                  spatial_enabled=spatial,
                                  use_albedo_demod=demod, bits=s.svgf_bits)

            if shadow_name:
                chains.append((cfg("SVGF_ShadowAO", False), shadow_name,
                               "ShadowAO_Denoised"))
                shadow_name = "ShadowAO_Denoised"
                variance_name = "SVGF_ShadowAO_Variance"
            if refl_name:
                chains.append((cfg("SVGF_Refl", True), refl_name,
                               "Reflection_Denoised"))
                refl_name = "Reflection_Denoised"
            if gi_name:
                chains.append((cfg("SVGF_GI", True), gi_name, "GI_Denoised"))
                gi_name = "GI_Denoised"
        if chains:
            self.add(graph, "SVGFPass",
                     passes.make_svgf_multi_pass(s, chains), "compute")

        self.add(graph, "CompositionPass",
                 passes.make_composition_pass(
                     s, shadow_name or "__none__", gi_name or "__none__",
                     refl_name or "__none__", variance_name), "graphics")
        self.add(graph, "PostProcessPass",
                 passes.make_postprocess_pass(s, RS.FINAL_COLOR), "graphics")
