"""RenderPathFactory (hybridrenderer_tpu/paths/factory.py). The forward
and hybrid paths are ported; the ray-traced path raises."""
from __future__ import annotations

from ..core.types import RenderPathType


def create_render_path(settings):
    from .forward import ForwardRenderPath
    from .hybrid import HybridRenderPath

    if settings.path == RenderPathType.FORWARD:
        return ForwardRenderPath(settings)
    if settings.path == RenderPathType.HYBRID:
        return HybridRenderPath(settings)
    if settings.path == RenderPathType.RAYTRACED:
        raise NotImplementedError("the RAYTRACED path is not ported yet")
    raise ValueError(f"unknown render path {settings.path}")
