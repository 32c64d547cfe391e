"""Visibility by homogeneous rasterization: each pixel centre is tested
against each triangle's three edge planes through the eye, in float64,
so a triangle that reaches behind the camera needs no clipping.

For a triangle with clip-space corners V_i = (x_i, y_i, w_i) and a
pixel at NDC (u, v), E_i = (u, v, 1) . (V_j x V_k) over the corners'
cyclic order; with D = V_0 . (V_1 x V_2), l_i = E_i / D are the
pixel's weights: it is covered where every l_i >= 0, its
perspective-correct barycentrics are l_i / sum(l), its clip w is
1 / sum(l) and its reversed-Z depth sum(l_i z_i). A covered pixel keeps
its nearest triangle: the largest depth in (0, 1], the lowest triangle
index on a tie. Triangles whose corners wind clockwise on screen
(D > 0) are back faces and are culled."""
from __future__ import annotations

import torch

PAIRS = 1 << 22       # (triangle, pixel) pairs evaluated at a time
LOW32 = 0xFFFFFFFF


def _planes(V):
    """V (T, 3, 3) rows (x, y, w) of each corner → (edge planes over D
    (T, 3, 3), D (T,))."""
    planes = torch.stack([torch.linalg.cross(V[:, 1], V[:, 2]),
                          torch.linalg.cross(V[:, 2], V[:, 0]),
                          torch.linalg.cross(V[:, 0], V[:, 1])], dim=1)
    D = (V[:, 0] * planes[:, 0]).sum(-1)
    safe = torch.where(D == 0, torch.ones_like(D), D)
    return planes / safe[:, None, None], D


def _weights(planes, u, v):
    """Each pixel's (N, 3, 3) scaled edge planes, NDC u, v (N,) → l
    (N, 3)."""
    return planes[..., 0] * u[:, None] + planes[..., 1] * v[:, None] \
        + planes[..., 2]


def _pixel_boxes(V, width, height, near):
    """Each triangle's pixel box: the bounds of its part in front of
    half the near plane, projected, one pixel wider each side."""
    w_min = 0.5 * near
    pts, ok = [], []
    for i in range(3):
        a, b = V[:, i], V[:, (i + 1) % 3]
        pts.append(a)
        ok.append(a[:, 2] >= w_min)
        crosses = (a[:, 2] - w_min) * (b[:, 2] - w_min) < 0
        s = (w_min - a[:, 2]) / torch.where(crosses, b[:, 2] - a[:, 2],
                                            torch.ones_like(a[:, 2]))
        pts.append(a + (b - a) * s[:, None])
        ok.append(crosses)
    P = torch.stack(pts, 1)                                  # (T, 6, 3)
    ok = torch.stack(ok, 1)
    w = torch.where(ok, P[..., 2], torch.ones_like(P[..., 2]))
    sx = (P[..., 0] / w * 0.5 + 0.5) * width
    sy = (P[..., 1] / w * 0.5 + 0.5) * height
    inf = torch.full_like(sx, float("inf"))
    x0 = torch.where(ok, sx, inf).amin(1)
    x1 = torch.where(ok, sx, -inf).amax(1)
    y0 = torch.where(ok, sy, inf).amin(1)
    y1 = torch.where(ok, sy, -inf).amax(1)
    some = ok.any(1)

    def lo(x, n):
        return torch.clamp(torch.floor(torch.nan_to_num(x, posinf=n,
                                                        neginf=0.0)) - 1,
                           0, n - 1).long()

    def hi(x, n):
        return torch.clamp(torch.ceil(torch.nan_to_num(x, posinf=n,
                                                       neginf=0.0)) + 1,
                           0, n - 1).long()

    return some, lo(x0, width), hi(x1, width), lo(y0, height), hi(y1, height)


def rasterize(clip, tris, width: int, height: int, near: float,
              single_sided=None):
    """clip (V, 4) f32 clip-space vertices (jitter applied), tris (T, 3)
    → (triangle of each pixel (H, W) i64, -1 where none; weights l
    (H, W, 3) f64 of that triangle there; depth (H, W) f32)."""
    dev = clip.device
    V = clip.double()[tris][..., [0, 1, 3]]                  # (T, 3, 3)
    planes, D = _planes(V)
    keep = D != 0
    if single_sided is not None:
        keep = keep & ~(single_sided & (D > 0))
    some, x0, x1, y0, y1 = _pixel_boxes(V, width, height, near)
    keep = keep & some & (x1 >= x0) & (y1 >= y0)
    ids = torch.nonzero(keep).squeeze(1)
    bw, bh = (x1 - x0 + 1)[ids], (y1 - y0 + 1)[ids]
    counts = bw * bh
    ends = torch.cumsum(counts, 0)
    zc = clip.double()[tris][..., 2]                         # (T, 3)
    best = torch.full((height * width,), -1, dtype=torch.int64, device=dev)

    a = 0
    n = ids.shape[0]
    ends_h = ends.cpu()
    while a < n:
        start = int(ends_h[a - 1]) if a else 0
        b = int(torch.searchsorted(ends_h, start + PAIRS, right=True))
        b = max(b, a + 1)
        sel = torch.arange(a, b, device=dev)
        owner = torch.repeat_interleave(sel, counts[a:b])
        first = ends[owner] - counts[owner]
        k = torch.arange(start, int(ends_h[b - 1]), device=dev) - first
        x = x0[ids[owner]] + k % bw[owner]
        y = y0[ids[owner]] + torch.div(k, bw[owner], rounding_mode="floor")
        t = ids[owner]
        u = (x.double() + 0.5) / width * 2 - 1
        v = (y.double() + 0.5) / height * 2 - 1
        lam = _weights(planes[t], u, v)
        z = (lam * zc[t]).sum(-1)
        cover = (lam >= 0).all(-1) & (z > 0) & (z <= 1)
        zf = z.float()
        key = (zf.view(torch.int32).long() << 32) | (LOW32 - t)
        best.scatter_reduce_(0, (y * width + x)[cover], key[cover], "amax")
        a = b

    hit = best >= 0
    tri = torch.where(hit, LOW32 - (best & LOW32), -1).view(height, width)
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    safe = torch.clamp(tri, min=0).reshape(-1)
    lam = _weights(planes[safe],
                   (xs.reshape(-1).double() + 0.5) / width * 2 - 1,
                   (ys.reshape(-1).double() + 0.5) / height * 2 - 1)
    depth = torch.where(hit.view(-1), (lam * zc[safe]).sum(-1),
                        torch.zeros_like(lam[:, 0]))
    return tri, lam.view(height, width, 3), depth.float().view(height, width)
