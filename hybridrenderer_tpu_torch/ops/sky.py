"""Environment / sky sampling (hybridrenderer_tpu/ops/sky.py): the
equirectangular sky texture, and the procedural gradient + sun glow
where the scene has none."""
from __future__ import annotations

import torch

from ..core import maths
from . import texture as tex_ops

PI = 3.14159265359


def sample_equirectangular_uv(v):
    """Direction → equirect uv."""
    phi = torch.atan2(v[..., 2], v[..., 0])
    theta = torch.asin(torch.clamp(v[..., 1], -1.0, 1.0))
    u = phi / (2.0 * PI) + 0.5
    w = 1.0 - (theta / PI + 0.5)
    return torch.stack([u, w], dim=-1)


def procedural_sky(direction):
    t = 0.5 * (direction[..., 1] + 1.0)
    horizon = maths.constant((0.4, 0.5, 0.6), direction.device)
    zenith = maths.constant((0.1, 0.2, 0.4), direction.device)
    sky = horizon + (zenith - horizon) * t.unsqueeze(-1)
    sun_dir = maths.normalize(maths.constant((1.0, 1.0, -1.0),
                                             direction.device))
    sun = torch.clamp(maths.dot(direction, sun_dir.expand_as(direction)),
                      min=0.0) ** 128.0
    return sky + sun.unsqueeze(-1) * 5.0


def sample_environment(direction, sky_texture, textures, ibl_enabled: bool,
                       has_sky: bool = True):
    """Radiance for rays that leave the scene; black with IBL off.
    ``sky_texture`` is the scene's sky texture id (-1: the procedural
    sky); ``has_sky`` is the scene's static flag, and without it the
    equirect fetch is skipped."""
    if not ibl_enabled:
        return torch.zeros(direction.shape[:-1] + (3,), dtype=torch.float32,
                           device=direction.device)
    if not has_sky:
        return procedural_sky(direction)
    uv = sample_equirectangular_uv(direction)
    tid = torch.full(direction.shape[:-1], int(sky_texture),
                     dtype=torch.int32, device=direction.device)
    env = tex_ops.sample_stack(textures, tid, uv, (0.0, 0.0, 0.0, 0.0))
    return torch.where((tid >= 0).unsqueeze(-1), env[..., :3],
                       procedural_sky(direction))
