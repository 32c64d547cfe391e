"""RenderPathFactory (hybridrenderer_tpu/paths/factory.py). Only the
hybrid path is ported; the forward and ray-traced paths raise."""
from __future__ import annotations

from ..core.types import RenderPathType


def create_render_path(settings):
    from .hybrid import HybridRenderPath

    if settings.path == RenderPathType.HYBRID:
        return HybridRenderPath(settings)
    if settings.path in (RenderPathType.FORWARD, RenderPathType.RAYTRACED):
        raise NotImplementedError(
            f"the {RenderPathType(settings.path).name} path is not ported yet")
    raise ValueError(f"unknown render path {settings.path}")
