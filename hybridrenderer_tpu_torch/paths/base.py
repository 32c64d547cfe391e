"""RenderPath base: builds a path's pass stack once per settings
(hybridrenderer_tpu/paths/base.py)."""
from __future__ import annotations

from ..graph.graph import RenderGraph
from ..graph.params import RS, FrameState


class RenderPath:
    kind = "base"

    def __init__(self, settings):
        self.settings = settings
        self.graph = RenderGraph(settings.width, settings.height)
        self.build_graph(self.graph)
        self.graph.compile()

    def build_graph(self, graph: RenderGraph):
        raise NotImplementedError

    def add(self, graph, name, builder, kind="compute"):
        fn, reads, writes, history = builder
        graph.add_pass(name, fn, reads, writes, history, kind)

    def export_mermaid(self) -> str:
        return self.graph.export_mermaid()

    def run(self, ctx, state: FrameState, run_pass=None):
        """Execute the pass stack → (output image, new FrameState,
        registry); ``run_pass``: RenderGraph.execute's hook."""
        registry, new_history = self.graph.execute({}, ctx, state,
                                                   run_pass=run_pass)
        return registry[RS.RENDER_OUTPUT], FrameState(history=new_history), \
            registry
