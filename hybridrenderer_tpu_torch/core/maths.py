"""Linear-algebra helpers on tensors (hybridrenderer_tpu/core/maths.py).

Matrices are row-major (4, 4) float32 tensors applied as ``M @ v``.
Three-component dot products and cross products are written out term
by term so that a CUDA kernel doing the same sums in the same order
gets the same bits.
"""
from __future__ import annotations

import numpy as np
import torch


_CONSTANTS = {}


def constant(values, device, dtype=torch.float32):
    """``torch.tensor(values)`` on ``device``, made once and cached: a
    frame's first (eager) run makes its constants, and the CUDA graph
    captured after it reads them without a host-to-device copy.
    ``values`` is a number or (nested) tuple; callers must not write to
    the result."""
    key = (values, str(torch.device(device)), dtype)
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(values, dtype=dtype,
                                           device=device)
    return t


def normalize(v, eps=1e-12):
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=eps)


def dot(a, b, keepdim=False):
    """Sum over the last axis of a * b, left to right."""
    out = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        out = out + a[..., i] * b[..., i]
    return out.unsqueeze(-1) if keepdim else out


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def length(v):
    return torch.linalg.vector_norm(v, dim=-1)


def reflect(i, n):
    """GLSL reflect: i - 2 dot(n, i) n (incident pointing at the surface)."""
    return i - 2.0 * dot(n, i, keepdim=True) * n


def mix(a, b, t):
    return a + (b - a) * t


def apply(m, v):
    """The (N, K) matrix ``m`` applied to (..., K) vectors → (..., N),
    each output a left-to-right sum of products. Per-pixel vectors go
    through this, not a matrix product: on the card a matrix product
    picks its kernel, and so its rounding, by the batch's size, and a
    row-sharded frame's shards must compute their pixels as the whole
    image does."""
    out = v[..., 0:1] * m[:, 0]
    for j in range(1, m.shape[1]):
        out = out + v[..., j:j + 1] * m[:, j]
    return out


def transform_point_h(m, p):
    """(4, 4) applied to (..., 3) points → homogeneous (..., 4)."""
    return apply(m[:, :3], p) + m[:, 3]


# ---------------------------------------------------------------------------
# Halton jitter (host side, numpy)
# ---------------------------------------------------------------------------

def halton(index: int, base: int) -> float:
    f, r = 1.0, 0.0
    i = int(index)
    while i > 0:
        f = f / base
        r = r + f * (i % base)
        i = i // base
    return r


def halton_jitter_sequence(width: int, height: int, phases: int = 16):
    """(phases, 2) NDC jitter table; phase index is ``frame % 16 + 1``."""
    out = np.zeros((phases, 2), np.float32)
    for p in range(phases):
        phase = p + 1
        out[p, 0] = (halton(phase, 2) - 0.5) * (2.0 / width)
        out[p, 1] = (halton(phase, 3) - 0.5) * (2.0 / height)
    return out


# ---------------------------------------------------------------------------
# Frustum culling
# ---------------------------------------------------------------------------

def frustum_from_viewproj(vp):
    """Gribb-Hartmann plane extraction → (6, 4) inward planes
    (left, right, bottom, top, far z>=0, near z<=w; reversed-Z)."""
    r0, r1, r2, r3 = vp[0], vp[1], vp[2], vp[3]
    planes = torch.stack([r3 + r0, r3 - r0, r3 + r1, r3 - r1, r2, r3 - r2])
    n = torch.linalg.vector_norm(planes[:, :3], dim=-1, keepdim=True)
    return planes / torch.clamp(n, min=1e-12)


def aabb_outside_frustum(mins, maxs, planes):
    """True where the AABB lies fully outside any plane (conservative)."""
    center = (mins + maxs) * 0.5
    extent = (maxs - mins) * 0.5
    d = center @ planes[:, :3].T + planes[:, 3]
    r = extent @ torch.abs(planes[:, :3]).T
    return torch.any(d + r < 0.0, dim=-1)
