"""Screen-space image helpers (hybridrenderer_tpu/ops/image.py)."""
from __future__ import annotations

import numpy as np
import torch


def shift(img, dy: int, dx: int):
    """Clamp-to-edge shifted image: out[y, x] = img[y+dy, x+dx]."""
    H, W = img.shape[0], img.shape[1]
    ys = torch.clamp(torch.arange(H, device=img.device) + dy, 0, H - 1)
    xs = torch.clamp(torch.arange(W, device=img.device) + dx, 0, W - 1)
    return img[ys][:, xs]


def pixel_uv_grid(height: int, width: int, device="cpu"):
    """(H, W, 2) uv at pixel centers, ``(ipos + 0.5) / size``. The divisor
    is a full tensor: PyTorch's CUDA backend divides by a Python scalar
    as a multiply by its reciprocal, which rounds differently from the
    true division of the CPU, the reference and the kernels."""
    def centers(n):
        x = torch.arange(n, dtype=torch.float32, device=device) + 0.5
        return x / torch.full_like(x, n)

    xs, ys = centers(width), centers(height)
    v, u = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([u, v], dim=-1)


def tri_boundary_mask(tri_id, dilate: int = 1):
    """Host-side (numpy) mask of triangle-boundary pixels: True where a
    pixel's triangle differs from any 4-neighbour, dilated ``dilate``
    times. Raster ties can only flip winners on such pixels."""
    t = np.asarray(tri_id)
    m = np.zeros(t.shape, bool)
    m[:-1, :] |= t[:-1, :] != t[1:, :]
    m[1:, :] |= t[:-1, :] != t[1:, :]
    m[:, :-1] |= t[:, :-1] != t[:, 1:]
    m[:, 1:] |= t[:, :-1] != t[:, 1:]
    for _ in range(dilate):
        d = m.copy()
        d[:-1, :] |= m[1:, :]
        d[1:, :] |= m[:-1, :]
        d[:, :-1] |= m[:, 1:]
        d[:, 1:] |= m[:, :-1]
        m = d
    return m
