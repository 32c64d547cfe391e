"""Renderer driver (hybridrenderer_tpu/runtime/renderer.py).

Runs the path's pass stack eagerly, one frame per ``render`` call, on
the device the scene lives on: CUDA scenes launch the port's kernels,
CPU scenes run their plain PyTorch versions. The history planes carry
from frame to frame in ``FrameState``; each frame builds a new dict of
new tensors (nothing is updated in place) and the previous frame's
tensors are freed when it is replaced.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.types import RenderFlags, RenderPathType
from ..graph.params import FrameParams, FrameState
from ..graph.passes import FrameContext
from ..paths.factory import create_render_path


class Renderer:
    def __init__(self, settings, scene_data, tracer=None):
        self.settings = settings
        self.scene = scene_data
        self.device = scene_data.device
        self.path = create_render_path(settings)
        self.tracer = tracer
        self.state = FrameState.empty()
        self.frame_count = 0
        self._stats = None

    @classmethod
    def for_scene(cls, settings, scene_data):
        """Renderer with the ray tracer attached when the flags ask for
        ray-traced passes."""
        needs_rt = settings.path == RenderPathType.RAYTRACED or bool(
            settings.flags & (RenderFlags.SHADOW | RenderFlags.AO
                              | RenderFlags.REFLECTION | RenderFlags.GI))
        tracer = None
        if needs_rt:
            from ..ops.trace import SceneTracer

            tracer = SceneTracer.build(scene_data, settings)
        return cls(settings, scene_data, tracer=tracer)

    @torch.no_grad()
    def render(self, cam_state, exposure: float = 1.0,
               svgf_phi=(4.0, 128.0, 0.02, 0.0)):
        """Render one frame → (H, W, 3) float32 tensor on the device."""
        params = FrameParams.create(self.scene, exposure=exposure,
                                    frame_index=self.frame_count,
                                    svgf_phi=svgf_phi)
        shadow_query = None
        if self.tracer is not None:
            shadow_query = self.tracer.shadow_query
        ctx = FrameContext(
            scene=self.scene, cam=cam_state.to(self.device), params=params,
            settings=self.settings, state=self.state,
            history_valid=self.frame_count > 0, shadow_query=shadow_query)
        out, self.state, registry = self.path.run(ctx, self.state)
        self._stats = registry.get("_FrameStats")
        self.frame_count += 1
        return out

    def render_np(self, cam_state, **kw) -> np.ndarray:
        return self.render(cam_state, **kw).cpu().numpy()

    def frame_stats(self) -> dict:
        """Last frame's instance drawn/culled counts and covered pixels
        (the active-ray count). Waits for the device."""
        s = np.zeros(3, np.int64) if self._stats is None \
            else self._stats.cpu().numpy()
        return {"instances_drawn": int(s[0]), "instances_culled": int(s[1]),
                "covered_pixels": int(s[2])}
