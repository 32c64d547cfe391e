"""Environment / sky sampling (hybridrenderer_tpu/ops/sky.py): the
procedural gradient + sun glow. Equirect sky textures are not ported
yet."""
from __future__ import annotations

import torch

from ..core import maths


def procedural_sky(direction):
    t = 0.5 * (direction[..., 1] + 1.0)
    horizon = direction.new_tensor([0.4, 0.5, 0.6])
    zenith = direction.new_tensor([0.1, 0.2, 0.4])
    sky = horizon + (zenith - horizon) * t.unsqueeze(-1)
    sun_dir = maths.normalize(direction.new_tensor([1.0, 1.0, -1.0]))
    sun = torch.clamp(maths.dot(direction, sun_dir.expand_as(direction)),
                      min=0.0) ** 128.0
    return sky + sun.unsqueeze(-1) * 5.0


def sample_environment(direction, ibl_enabled: bool, has_sky: bool = False):
    """Radiance for rays that leave the scene; black with IBL off."""
    if not ibl_enabled:
        return torch.zeros(direction.shape[:-1] + (3,), dtype=torch.float32,
                           device=direction.device)
    if has_sky:
        raise NotImplementedError("equirect sky textures are not ported yet")
    return procedural_sky(direction)
