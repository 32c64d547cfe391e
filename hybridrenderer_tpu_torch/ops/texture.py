"""Texture sampling (hybridrenderer_tpu/ops/texture.py), the no-texture
case only. Bilinear sampling of bound textures is not ported yet: any
lookup into a non-empty texture stack raises."""
from __future__ import annotations

import torch


def has_textures(textures) -> bool:
    """The empty TextureStack placeholder is (1, 1, 1, 4)."""
    return textures.data.shape[1] > 1 or textures.data.shape[2] > 1


def sample_stack(textures, tex_id, uv, default):
    """``default`` everywhere for the empty stack; a bound texture raises."""
    if has_textures(textures):
        raise NotImplementedError(
            "texture sampling is not ported yet (only scenes with no "
            "bound texture render)")
    default = torch.as_tensor(default, dtype=torch.float32, device=uv.device)
    return default.expand(*tex_id.shape, default.shape[-1])
