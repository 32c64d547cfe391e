"""The system under test, hybridrenderer_tpu_torch, as a cell drives
it: the scene built from the benchmark's arrays through the port's
host Scene, its ``Renderer``, and one frame through the entry the cell
times: ``Renderer.render``, or ``DynamicScene.commit_and_render`` where
the traffic moves entities. A configuration with ``"shards": n`` (n > 1)
renders through ``ShardedRenderer`` instead, its rows split over a mesh
of n devices: ``cuda:0`` ... ``cuda:n-1``, or n shards on one CPU. Only
the port's public classes are used.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from . import scenegen
from .settings import render_settings


class Program:
    def __init__(self, cfg: dict, desc, traffic, device):
        from hybridrenderer_tpu_torch.core.camera import CameraState
        from hybridrenderer_tpu_torch.core.config import RenderSettings
        from hybridrenderer_tpu_torch.core.types import (RenderFlags,
                                                         RenderPathType)
        from hybridrenderer_tpu_torch.runtime.renderer import Renderer
        from hybridrenderer_tpu_torch.scene.dynamic import DynamicScene
        from hybridrenderer_tpu_torch.scene.geometry import MeshData
        from hybridrenderer_tpu_torch.scene.scene import Scene
        from hybridrenderer_tpu_torch.scene.schema import (Material,
                                                           TextureStack)

        self._camera = CameraState.create
        self.traffic = traffic
        settings = render_settings(cfg["render"], RenderSettings,
                                   RenderFlags, RenderPathType)
        host = scenegen.build_host_scene(desc, Scene, Material, MeshData,
                                         TextureStack, torch.from_numpy)
        data = host.build(device)
        shards = cfg.get("shards", 1)
        if shards == 1:
            self.renderer = Renderer.for_scene(settings, data)
            self.devices = [device]
        else:
            from hybridrenderer_tpu_torch.parallel.mesh import make_mesh
            from hybridrenderer_tpu_torch.parallel.sharded import \
                ShardedRenderer

            mesh = make_mesh(shards) if device.type == "cuda" \
                else make_mesh(devices=[device] * shards)
            self.renderer = ShardedRenderer.for_scene(settings, data, mesh)
            self.devices = list(mesh.distinct)
        self.dynamic = DynamicScene(host, self.renderer) \
            if traffic.moved else None

    def frame(self, k: int):
        """Frame k of the traffic → the image, (H, W, 3) f32 on the
        first device (not waited for)."""
        with record_function("camera"):
            cs = self._camera(*self.traffic.camera(k))
        if self.dynamic is None:
            with record_function("render"):
                return self.renderer.render(cs)
        with record_function("set_entity_transform"):
            for e, t in self.traffic.transforms(k).items():
                self.dynamic.set_entity_transform(e, t)
        with record_function("commit_and_render"):
            return self.dynamic.commit_and_render(cs)

    def reset_history(self):
        """The next frame is a first frame; the captured graphs stay."""
        self.renderer.reset_history()

    def planes(self) -> dict:
        """The planes the last frame left in the renderer's history, on
        the host, under compare.py's names, and ``device_depth``, the
        raster's reversed-Z depth, which the forward reference's TAA
        reads: a sharded renderer's shards' rows joined in rank order."""
        hs = getattr(self.renderer, "histories", None) \
            or [self.renderer.state.history]

        def host(name):   # a copy: the renderer reuses its buffers
            return torch.cat([h[name].to("cpu", copy=True) for h in hs])

        out = {"object_id": host("ObjectID").long(),
               "normal": host("Normal").float(),
               "motion": host("Motion").float()}
        out["depth"] = out["motion"][..., 2]
        if "Depth" in hs[0]:          # reversed-Z, as the raster wrote it
            out["device_depth"] = host("Depth").float()
        for name, prefix in (("shadow_ao", "SVGF_ShadowAO"),
                             ("reflection", "SVGF_Refl"), ("gi", "SVGF_GI")):
            if prefix + "Moments" in hs[0]:
                out[name] = host(prefix + "Moments")[..., 0].float()
        return out

    def capture_ms(self) -> float:
        return float(sum(self.renderer.capture_ms.values()))

    def close(self):
        self.dynamic = self.renderer = None
