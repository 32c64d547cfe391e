"""Forward render path (hybridrenderer_tpu/paths/forward.py):
GBufferRaster → ForwardPass → TAAPass → PostProcessPass("TAAOutput")."""
from __future__ import annotations

from ..graph import passes
from ..graph.params import RS
from .base import RenderPath


class ForwardRenderPath(RenderPath):
    kind = "forward"

    def build_graph(self, graph):
        s = self.settings
        self.add(graph, "GBufferRaster", passes.make_gbuffer_pass(s),
                 "graphics")
        self.add(graph, "ForwardPass", passes.make_forward_pass(s), "graphics")
        self.add(graph, "TAAPass", passes.make_taa_pass(s), "compute")
        self.add(graph, "PostProcessPass",
                 passes.make_postprocess_pass(s, RS.TAA_OUTPUT), "graphics")
