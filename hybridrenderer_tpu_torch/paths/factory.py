"""RenderPathFactory (hybridrenderer_tpu/paths/factory.py)."""
from __future__ import annotations

from ..core.types import RenderPathType


def create_render_path(settings):
    from .forward import ForwardRenderPath
    from .hybrid import HybridRenderPath
    from .raytraced import RayTracedRenderPath

    paths = {RenderPathType.FORWARD: ForwardRenderPath,
             RenderPathType.HYBRID: HybridRenderPath,
             RenderPathType.RAYTRACED: RayTracedRenderPath}
    if settings.path not in paths:
        raise ValueError(f"unknown render path {settings.path}")
    return paths[settings.path](settings)
