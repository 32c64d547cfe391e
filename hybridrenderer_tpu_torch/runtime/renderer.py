"""Renderer driver (hybridrenderer_tpu/runtime/renderer.py).

Runs the path's pass stack eagerly, one frame per ``render`` call, on
the device the scene lives on: CUDA scenes launch the port's kernels,
CPU scenes run their plain PyTorch versions. The history planes carry
from frame to frame in ``FrameState``; each frame builds a new dict of
new tensors (nothing is updated in place) and the previous frame's
tensors are freed when it is replaced.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.types import RenderFlags, RenderPathType
from ..graph.params import FrameParams, FrameState
from ..graph.passes import FrameContext
from ..ops import trace
from ..paths.factory import create_render_path
from ..scene import dynamic


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
        """Renderer with the ray tracer attached when the path or the
        flags ask for ray-traced passes."""
        tracer = trace.SceneTracer.build(scene_data, settings) \
            if _needs_tracer(settings, scene_data) else None
        return cls(settings, scene_data, tracer=tracer)

    @torch.no_grad()
    def render(self, cam_state, exposure: float = 1.0,
               svgf_phi=(4.0, 128.0, 0.02, 0.0)):
        """Render one frame → (H, W, 3) float32 tensor on the device."""
        params = FrameParams.create(self.scene, exposure=exposure,
                                    frame_index=self.frame_count,
                                    svgf_phi=svgf_phi)
        shadow_query = trace_radiance = None
        if self.tracer is not None:
            tracer, scene = self.tracer, self.scene
            shadow_query = tracer.shadow_query

            def trace_radiance(o, d, ctx, depth, active=None):
                return tracer.trace_radiance(scene, o, d, ctx, depth,
                                             active=active)
        ctx = FrameContext(
            scene=self.scene, cam=cam_state.to(self.device), params=params,
            settings=self.settings, state=self.state,
            history_valid=self.frame_count > 0, shadow_query=shadow_query,
            trace_radiance=trace_radiance)
        out, self.state, registry = self.path.run(ctx, self.state)
        self._stats = registry.get("_FrameStats")
        self.frame_count += 1
        return out

    def render_np(self, cam_state, **kw) -> np.ndarray:
        return self.render(cam_state, **kw).cpu().numpy()

    def update_dynamic(self, maps, transforms, vert_idx, tri_idx,
                       use_subset: bool, update_lights: bool):
        """A dynamic update of ``self.scene`` (scene/dynamic.py; only the
        dirty rows ``vert_idx`` / ``tri_idx`` when ``use_subset``), then
        the tracer's refit: ``DynamicScene.commit``'s work."""
        if use_subset:
            self.scene = dynamic.update_transforms_subset(
                self.scene, maps, transforms, vert_idx, tri_idx,
                update_lights=update_lights)
        else:
            self.scene = dynamic.update_transforms(self.scene, maps,
                                                   transforms)
        if self.tracer is not None:
            self.tracer = self.tracer.refit(self.scene)

    def render_dynamic(self, cam_state, maps, transforms, vert_idx, tri_idx,
                       use_subset: bool, update_lights: bool, **kw):
        """A dynamic frame in one call: ``update_dynamic``, then the
        frame. The reference fuses the two into one jitted dispatch;
        eager PyTorch runs them in order."""
        self.update_dynamic(maps, transforms, vert_idx, tri_idx, use_subset,
                            update_lights)
        return self.render(cam_state, **kw)

    def render_burst(self, cam_states, exposure: float = 1.0,
                     svgf_phi=(4.0, 128.0, 0.02, 0.0)):
        """Render one frame per camera state in order → (K, H, W, 3). The
        history carries from frame to frame exactly as through K
        ``render`` calls; the reference's one-dispatch burst has no
        counterpart in eager PyTorch."""
        return torch.stack([self.render(cs, exposure=exposure,
                                        svgf_phi=svgf_phi)
                            for cs in cam_states])

    def switch_path(self, path_type):
        """Live render-path switch: new pass stack, history dropped; the
        scene is kept, and the tracer too unless the new path needs one
        that is missing."""
        self.apply_settings(path=path_type)

    def apply_settings(self, **changes):
        """Live settings change (flags, display mode, resolution, path,
        trace_backend): rebuild the pass stack, keep the scene, drop the
        history. The tracer is kept while it still serves (the reference
        keeps it whatever changes), built when one is needed and missing,
        and rebuilt when trace_backend or wide_kernel moves to another
        traversal kernel, so that the setting takes effect."""
        settings = self.settings.replace(**changes)
        path = create_render_path(settings)
        if _needs_tracer(settings, self.scene) and (
                self.tracer is None or self.tracer.packet
                != (settings.trace_backend == "pallas")
                or self.tracer.wide_kernel != trace.wide_kernel_of(settings)):
            self.tracer = trace.SceneTracer.build(self.scene, settings)
        self.settings, self.path = settings, path
        self.reset_history()

    def reset_history(self):
        """Drop all carried history: the next frame is a first frame."""
        self.state = FrameState.empty()
        self.frame_count = 0

    def benchmark(self, camera, frames: int = 32, warmup: int = 4) -> dict:
        """Steady-state frame rate over ``frames`` frames after
        ``warmup``, the camera stepping with TAA jitter; the device is
        synchronised before each clock reading."""
        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        for _ in range(warmup):
            self.render(camera.step(taa_enabled=True))
        sync()
        t0 = time.perf_counter()
        for _ in range(frames):
            self.render(camera.step(taa_enabled=True))
        sync()
        dt = time.perf_counter() - t0
        return {"fps": frames / dt, "ms_per_frame": 1000.0 * dt / frames}

    def frame_stats(self) -> dict:
        """Last frame's instance drawn/culled counts and covered pixels
        (the active-ray count). Waits for the device."""
        s = np.zeros(3, np.int64) if self._stats is None \
            else self._stats.cpu().numpy()
        return {"instances_drawn": int(s[0]), "instances_culled": int(s[1]),
                "covered_pixels": int(s[2])}



def _needs_tracer(settings, scene_data) -> bool:
    """Whether the settings run ray-traced passes. Radiance rays (the
    reflection and GI passes, and the ray-traced path's primary rays) on
    a scene above SHADE_ROWS_MAX triangles raise, before any BVH is
    built: there the reference shades from a quantized table, which is
    not ported."""
    raytraced = settings.path == RenderPathType.RAYTRACED
    radiance = raytraced or bool(settings.flags & (RenderFlags.REFLECTION
                                                   | RenderFlags.GI))
    if radiance and scene_data.num_triangles > trace.SHADE_ROWS_MAX:
        raise NotImplementedError(
            f"radiance rays (reflection, GI, the ray-traced path) above "
            f"{trace.SHADE_ROWS_MAX} triangles (the quantized shade_rows_q "
            f"fetch) are not ported yet")
    return raytraced or bool(settings.flags & (
        RenderFlags.SHADOW | RenderFlags.AO | RenderFlags.REFLECTION
        | RenderFlags.GI))
