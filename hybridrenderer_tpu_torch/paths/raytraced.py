"""Ray-traced render path (hybridrenderer_tpu/paths/raytraced.py):
DepthPrepass → RaytracePass (primary camera rays) → TAAPass →
PostProcessPass("TAAOutput")."""
from __future__ import annotations

from ..graph import passes, rt_passes
from ..graph.params import RS
from .base import RenderPath


class RayTracedRenderPath(RenderPath):
    kind = "raytraced"

    def build_graph(self, graph):
        s = self.settings
        self.add(graph, "DepthPrepass", passes.make_depth_prepass(s),
                 "graphics")
        self.add(graph, "RaytracePass", rt_passes.make_primary_rt_pass(s),
                 "raytracing")
        self.add(graph, "TAAPass", passes.make_taa_pass(s, use_gbuffer=False),
                 "compute")
        self.add(graph, "PostProcessPass",
                 passes.make_postprocess_pass(s, RS.TAA_OUTPUT), "graphics")
