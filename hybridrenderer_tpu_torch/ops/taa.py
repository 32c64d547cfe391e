"""Temporal anti-aliasing resolve (hybridrenderer_tpu/ops/taa.py, taa.comp):
3x3 velocity dilation toward the closest reversed-Z depth, jitter-
compensated reprojection, YCoCg with a firefly-suppressing tonemap, the
variance neighbourhood AABB with ray-box history clipping, and the
motion-adaptive blend. The history fetch is kernel K5
(ops/temporal_cuda.window_sample), the per-pixel bilinear sample of the
reference's CPU path: no pixel loses its history to a tile window.
"""
from __future__ import annotations

import torch

from . import image as img_ops
from .temporal_cuda import window_sample


def _rgb_to_ycocg(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return torch.stack([0.25 * r + 0.5 * g + 0.25 * b, 0.5 * r - 0.5 * b,
                        -0.25 * r + 0.5 * g - 0.25 * b], dim=-1)


def _ycocg_to_rgb(c):
    y, co, cg = c[..., 0], c[..., 1], c[..., 2]
    return torch.stack([y + co - cg, y + cg, y - co - cg], dim=-1)


def _tonemap(c):
    c = torch.where(torch.isfinite(c), c, torch.zeros_like(c))
    c = torch.clamp(c, min=0.0)
    return c / (1.0 + c.amax(dim=-1, keepdim=True))


def _untonemap(c):
    lum = c.amax(dim=-1, keepdim=True)
    return c / torch.clamp(1.0 - lum, min=0.0001)


def _clip_history(history, box_min, box_max):
    """Ray-box clip of history toward the box centre (taa.comp:49-67)."""
    filtered = (box_min + box_max) * 0.5
    ray_dir = filtered - history
    ray_dir = torch.where(torch.abs(ray_dir) < 1e-5,
                          torch.full_like(ray_dir, 1e-5), ray_dir)
    inv = 1.0 / ray_dir
    t_min = (box_min - history) * inv
    t_max = (box_max - history) * inv
    enter = torch.minimum(t_min, t_max)
    t = torch.clamp(enter.amax(dim=-1, keepdim=True), 0.0, 1.0)
    return history + (filtered - history) * t


def resolve(cur_color, history_color, motion, depth, jitter, prev_jitter,
            history_valid: bool, enabled: bool = True):
    """TAA resolve of (H, W, 3) colour against (H, W, 3) history.
    ``motion`` is the G-buffer's (H, W, 2) uv motion, ``depth``
    reversed-Z, jitters in NDC units (x 0.5 → uv)."""
    if not enabled:
        return cur_color
    H, W = depth.shape
    dev = depth.device
    uv = img_ops.pixel_uv_grid(H, W, dev)

    # 1. velocity dilation: the motion of the 3x3-closest pixel
    best_d = best_motion = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            d = img_ops.shift(depth, dy, dx)
            m = img_ops.shift(motion, dy, dx)
            if best_d is None:
                best_d, best_motion = d, m
            else:
                best_motion = torch.where((d > best_d).unsqueeze(-1), m,
                                          best_motion)
                best_d = torch.maximum(d, best_d)

    # 2. reprojection with jitter compensation
    cur_j = jitter * 0.5
    prev_j = prev_jitter * 0.5
    prev_uv = uv - cur_j - best_motion + prev_j

    cur_ycocg = _rgb_to_ycocg(_tonemap(cur_color))

    # 3. neighbourhood statistics AABB
    m1 = torch.zeros_like(cur_ycocg)
    m2 = torch.zeros_like(cur_ycocg)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            c = _rgb_to_ycocg(_tonemap(img_ops.shift(cur_color, dy, dx)))
            m1 = m1 + c
            m2 = m2 + c * c
    mu = m1 / 9.0
    sigma = torch.sqrt(torch.clamp(m2 / 9.0 - mu * mu, min=0.0))
    box_min = mu - 1.5 * sigma
    box_max = mu + 1.5 * sigma

    # 4. sample (K5) and clip the history
    off = ((prev_uv[..., 0] < 0.0) | (prev_uv[..., 0] > 1.0)
           | (prev_uv[..., 1] < 0.0) | (prev_uv[..., 1] > 1.0)).unsqueeze(-1)
    history = window_sample(history_color.contiguous(), prev_uv.contiguous())
    hist_ycocg = _clip_history(_rgb_to_ycocg(_tonemap(history)), box_min,
                               box_max)

    # 5. motion-adaptive blend
    size = uv.new_tensor([W, H])
    motion_len = torch.linalg.vector_norm(best_motion * size, dim=-1)
    alpha = torch.clamp(0.1 + motion_len * 0.1, 0.1, 0.9).unsqueeze(-1)
    alpha = torch.where(off, torch.ones_like(alpha), alpha)
    if not history_valid:
        alpha = torch.ones_like(alpha)
    resolved = hist_ycocg + (cur_ycocg - hist_ycocg) * alpha
    return _untonemap(_ycocg_to_rgb(resolved))
