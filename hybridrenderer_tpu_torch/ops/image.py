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


def pixel_uv_grid(height: int, width: int, device, row0: int = 0,
                  full_height=None):
    """(H, W, 2) uv at pixel centers, ``(ipos + 0.5) / size``: rows
    ``row0`` .. ``row0 + height - 1`` of an image ``full_height`` rows
    tall (default: the whole image). The divisor is a full tensor:
    PyTorch's CUDA backend divides by a Python scalar as a multiply by
    its reciprocal, which rounds differently from the true division of
    the CPU, the reference and the kernels."""
    def centers(n, first, size):
        x = torch.arange(first, first + n, dtype=torch.float32,
                         device=device) + 0.5
        return x / torch.full_like(x, size)

    xs = centers(width, 0, width)
    ys = centers(height, row0, height if full_height is None
                 else full_height)
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


def upsample2x_depth_aware(val_half, z_half, z_full, sigma_scale=0.1,
                           row0: int = 0, half_row0: int = 0,
                           full_height=None):
    """Joint (depth-guided) bilateral 2x upsample of a half-res signal:
    each full-res pixel blends the four nearest half-res samples with
    bilinear x depth-similarity weights. ``z_half`` is the linear depth
    of the pixels the half-res signal was traced from, ``z_full`` the
    full-res linear depth. Where every tap is rejected the pixel keeps
    its own quad's value.

    In a window of rows: ``z_full`` holds image rows ``row0`` on of an
    image ``full_height`` rows tall, the half-res planes half-res rows
    ``half_row0`` on, which must cover one more half-res row above and
    below the window's own (none past the image's edge)."""
    H, W = z_full.shape[:2]
    FH = H if full_height is None else full_height
    dev = z_full.device
    # the full-res rows the half-res block covers, from 2 half_row0
    n = min(2 * val_half.shape[0], FH - 2 * half_row0)
    up = val_half.repeat_interleave(2, 0).repeat_interleave(2, 1)[:n, :W]
    zu = z_half.repeat_interleave(2, 0).repeat_interleave(2, 1)[:n, :W]
    first = row0 - 2 * half_row0
    odd_y = ((torch.arange(n, device=dev)[:, None] + 2 * half_row0)
             & 1).bool()
    odd_x = (torch.arange(W, device=dev)[None, :] & 1).bool()
    chans = up.dim() == 3

    def quad_neighbor(img, axis):
        # even rows/cols sit in the top/left half of their quad: the
        # nearest other quad is above/left; odd ones look below/right
        par = odd_y if axis == 0 else odd_x
        if img.dim() == 3:
            par = par.unsqueeze(-1)
        if axis == 0:
            return torch.where(par, shift(img, 2, 0), shift(img, -2, 0))
        return torch.where(par, shift(img, 0, 2), shift(img, 0, -2))

    taps = tuple((v[first:first + H], z[first:first + H], wb) for v, z, wb in (
        (up, zu, 0.75 * 0.75),
        (quad_neighbor(up, 1), quad_neighbor(zu, 1), 0.25 * 0.75),
        (quad_neighbor(up, 0), quad_neighbor(zu, 0), 0.75 * 0.25),
        (quad_neighbor(quad_neighbor(up, 0), 1),
         quad_neighbor(quad_neighbor(zu, 0), 1), 0.25 * 0.25),
    ))
    up = up[first:first + H]
    sigma = sigma_scale * torch.clamp(torch.abs(z_full), min=1e-3)
    acc = torch.zeros_like(up)
    wacc = torch.zeros_like(z_full)
    for v, z, wb in taps:
        w = wb * torch.exp(-torch.abs(z - z_full) / sigma)
        acc = acc + v * (w.unsqueeze(-1) if chans else w)
        wacc = wacc + w
    wsafe = torch.clamp(wacc, min=1e-6)
    norm = acc / (wsafe.unsqueeze(-1) if chans else wsafe)
    keep = wacc > 1e-6
    return torch.where(keep.unsqueeze(-1) if chans else keep, norm, up)
