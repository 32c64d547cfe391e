"""Ray queries over the scene BVH (hybridrenderer_tpu/ops/trace.py):
``SceneTracer.build`` and the visibility query the shadow and AO passes
call. Closest-hit radiance tracing is not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from . import sampling
from .bvh import build_sah
from .trace_cuda import PackedBVH, intersect_any, pack_bvh

TMIN = 0.01  # shadow_query's ray start, past the normal offset


@dataclasses.dataclass
class SceneTracer:
    packed: PackedBVH

    @staticmethod
    def build(scene_data, settings=None) -> "SceneTracer":
        """Binned-SAH BVH over the scene's triangle soup, on the scene's
        device. Alpha-tested scenes need closest-hit rounds, which are
        not ported yet."""
        if scene_data.has_alpha_test:
            raise NotImplementedError(
                "alpha-tested (cut-out) occlusion is not ported yet")
        soup = scene_data.triangles
        bvh = build_sah(soup.v0, soup.v1, soup.v2)
        return SceneTracer(packed=pack_bvh(bvh, soup.v0, soup.v1, soup.v2))

    def shadow_rays(self, world_pos, normal, direction, tmax, active=None):
        """The rays of ``shadow_query`` as ``intersect_any`` takes them:
        (o (R, 3), d (R, 3), tmax (R,), active (R,)) with R = H * W."""
        H, W = world_pos.shape[:2]
        dev = world_pos.device
        origin = sampling.offset_ray(world_pos, normal).reshape(-1, 3)
        d = direction.expand(H, W, 3).reshape(-1, 3).contiguous()
        t = torch.full((H * W,), min(float(tmax), 10000.0),
                       dtype=torch.float32, device=dev)
        act = torch.ones((H * W,), dtype=torch.bool, device=dev) \
            if active is None else active.reshape(-1).contiguous()
        return origin.contiguous(), d, t, act

    def shadow_query(self, world_pos, normal, direction, tmax, active=None):
        """Visibility (1.0 unoccluded) over (H, W) images: origins offset
        along the normal, tmin 0.01, tmax capped at 10000. ``active``
        (H, W) masks rays out entirely; they report 1.0."""
        o, d, t, act = self.shadow_rays(world_pos, normal, direction, tmax,
                                        active)
        tri = intersect_any(self.packed, o, d, TMIN, t, act)
        return torch.where(tri >= 0, 0.0, 1.0).reshape(world_pos.shape[:2])
