"""Vertex transform, near-plane clip and back-face cull
(hybridrenderer_tpu/ops/raster.py, stage 1 of the rasterizer).

Stage 2, coverage and depth resolve, is the binned tile kernel in
ops/raster_cuda.py. Clipped vertices carry barycentrics with respect to
the original triangle, so everything downstream is clip-agnostic. Depth
is reversed-Z NDC (near 1, far 0), resolved by maximum.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core import maths

W_CLIP = 1e-4  # near-plane clip epsilon in w (w = -z_view)
AREA_EPS = 1e-12


@dataclasses.dataclass
class ClippedTriangles:
    """Post-clip screen-space triangle set: 2 slots per input triangle."""

    sxy: Any      # (T2, 3, 2) screen coords (pixel units)
    z: Any        # (T2, 3) NDC depth (reversed-Z)
    inv_w: Any    # (T2, 3) 1/w_clip
    bary: Any     # (T2, 3, 3) barycentrics w.r.t. the original triangle
    tri_id: Any   # (T2,) original triangle index
    valid: Any    # (T2,) bool


@dataclasses.dataclass
class VisibilityBuffer:
    """Per-pixel raster result: the raster → G-buffer contract."""

    tri_id: Any  # (H, W) i32, -1 = background
    bary1: Any   # (H, W) f32 perspective-correct barycentric of v1
    bary2: Any   # (H, W) f32 ... of v2
    depth: Any   # (H, W) f32 reversed-Z NDC (0 = background)


def transform_to_clip(world_pos, view_proj, jitter=None):
    """World → clip, with TAA jitter added as ``xy += jitter * w``."""
    clip = world_pos @ view_proj[:3, :3].T + view_proj[:3, 3]
    w = world_pos @ view_proj[3, :3] + view_proj[3, 3]
    if jitter is not None:
        clip = torch.cat([clip[..., :2] + jitter * w.unsqueeze(-1),
                          clip[..., 2:]], dim=-1)
    return torch.cat([clip, w.unsqueeze(-1)], dim=-1)


# rotation that puts in-front vertices first, indexed by the in-front
# bitmask in0 | in1 << 1 | in2 << 2 (winding preserved)
_PERM = ((0, 1, 2), (0, 1, 2), (1, 2, 0), (0, 1, 2),
         (2, 0, 1), (2, 0, 1), (1, 2, 0), (0, 1, 2))


def clip_triangles(corners, width, height, tri_mask=None,
                   single_sided=None) -> ClippedTriangles:
    """Near-plane (w >= W_CLIP) clip of (T, 3, 4) clip-space corners into
    2 static slots per triangle. ``single_sided`` (T,) bool culls those
    triangles' back faces by screen-space winding."""
    v = corners
    T = v.shape[0]
    dev = v.device
    w = v[..., 3]
    infront = w >= W_CLIP
    m = (infront[:, 0].long() + 2 * infront[:, 1].long()
         + 4 * infront[:, 2].long())
    n_in = infront.sum(dim=1)

    perm = maths.constant(_PERM, dev, torch.int64)[m]              # (T, 3)
    u = torch.gather(v, 1, perm.unsqueeze(-1).expand(T, 3, 4))
    # one-hot rows (one_hot itself checks the indices on the host)
    ub = (perm.unsqueeze(-1)
          == torch.arange(3, device=dev)).float()                  # (T, 3, 3)

    def lerp_to_plane(a, ab, b, bb):
        den = a[..., 3] - b[..., 3]
        den = torch.where(torch.abs(den) < 1e-12,
                          torch.full_like(den, 1e-12), den)
        t = torch.clamp((a[..., 3] - W_CLIP) / den, 0.0, 1.0).unsqueeze(-1)
        return a + t * (b - a), ab + t * (bb - ab)

    u0, u1, u2 = u[:, 0], u[:, 1], u[:, 2]
    b0, b1, b2 = ub[:, 0], ub[:, 1], ub[:, 2]
    a2, ab2 = lerp_to_plane(u1, b1, u2, b2)
    c2, cb2 = lerp_to_plane(u0, b0, u2, b2)
    a1, ab1 = lerp_to_plane(u0, b0, u1, b1)
    c1, cb1 = lerp_to_plane(u0, b0, u2, b2)

    two_in = (n_in == 2).unsqueeze(-1)
    full = (n_in == 3).unsqueeze(-1)

    def sel(va, vb, vc):  # full / two_in / one_in
        return torch.where(full, va, torch.where(two_in, vb, vc))

    # slot A: full (u0,u1,u2); two_in (u0,u1,a2); one_in (u0,a1,c1)
    # slot B: two_in (u0,a2,c2); degenerate otherwise
    pos = torch.cat([torch.stack([u0, sel(u1, u1, a1), sel(u2, a2, c1)], 1),
                     torch.stack([u0, a2, c2], 1)], dim=0)         # (2T, 3, 4)
    bary = torch.cat([torch.stack([b0, sel(b1, b1, ab1),
                                   sel(b2, ab2, cb1)], 1),
                      torch.stack([b0, ab2, cb2], 1)], dim=0)
    valid = torch.cat([n_in > 0, n_in == 2])
    if tri_mask is not None:
        valid = valid & torch.cat([tri_mask, tri_mask])
    ids = torch.arange(T, dtype=torch.int32, device=dev)
    tri_id = torch.cat([ids, ids])

    wv = torch.clamp(pos[..., 3], min=W_CLIP * 0.5)
    inv_w = 1.0 / wv
    ndc = pos[..., :3] * inv_w.unsqueeze(-1)
    sx = (ndc[..., 0] * 0.5 + 0.5) * width
    sy = (ndc[..., 1] * 0.5 + 0.5) * height
    if single_sided is not None:
        # front faces have negative signed area in y-down screen space
        area2 = ((sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0])
                 - (sy[:, 1] - sy[:, 0]) * (sx[:, 2] - sx[:, 0]))
        ss2 = torch.cat([single_sided, single_sided])
        valid = valid & ~(ss2 & (area2 > 0.0))
    return ClippedTriangles(sxy=torch.stack([sx, sy], dim=-1), z=ndc[..., 2],
                            inv_w=inv_w, bary=bary, tri_id=tri_id,
                            valid=valid)


def edge_coeffs(pa, pb):
    """Edge function cross(b - a, p - a) as alpha*x + beta*y + gamma."""
    alpha = -(pb[..., 1] - pa[..., 1])
    beta = pb[..., 0] - pa[..., 0]
    gamma = (pb[..., 1] - pa[..., 1]) * pa[..., 0] \
        - (pb[..., 0] - pa[..., 0]) * pa[..., 1]
    return alpha, beta, gamma
