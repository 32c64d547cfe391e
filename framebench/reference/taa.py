"""TAA's resolve for the reference (taa.comp, as the JAX package's
ops/taa.py has it), written out plainly in float32: the motion of the
nearest of each pixel's 3 x 3 neighbours; the pixel's uv, moved back by
that motion and by the change of jitter; the current colours, tonemapped
(c / (1 + max c)) and in YCoCg, whose 3 x 3 mean +- 1.5 standard
deviations make a box; the history, sampled bilinearly there (taps
clamped to the image) and clipped along the ray to the box's centre onto
its surface; and the blend, whose weight of the current colour grows
with the motion, 0.1 + 0.1 per pixel moved, within [0.1, 0.9], and is 1
where the uv left the image or there is no history yet.

Departures from the JAX package: none in the arithmetic. The nearest
neighbour is chosen by a depth the caller hands in (``nearness``, larger
nearer, as the reversed-Z depth the JAX package compares); forward.py
hands in the program's own, since a last-place difference of two depths
can change which neighbour's motion a pixel takes. The history is
fetched for each pixel (the JAX package's "pixel" gather, which the
port's K5 does), not through its TPU tile windows."""
from __future__ import annotations

import torch

ALPHA_MIN, ALPHA_MAX, ALPHA_PER_PIXEL = 0.1, 0.9, 0.1
BOX_SIGMAS = 1.5


def shifted(x, dy: int, dx: int):
    """out[y, x] = x[y + dy, x + dx], the indices clamped to the
    image."""
    H, W = x.shape[:2]
    ys = torch.clamp(torch.arange(H, device=x.device) + dy, 0, H - 1)
    xs = torch.clamp(torch.arange(W, device=x.device) + dx, 0, W - 1)
    return x[ys[:, None], xs[None, :]]


NEIGHBOURS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def tonemap(c):
    c = torch.clamp(torch.where(torch.isfinite(c), c, torch.zeros_like(c)),
                    min=0.0)
    return c / (1.0 + c.amax(-1, keepdim=True))


def untonemap(c):
    return c / torch.clamp(1.0 - c.amax(-1, keepdim=True), min=1e-4)


def ycocg(rgb):
    r, g, b = rgb.unbind(-1)
    return torch.stack([0.25 * r + 0.5 * g + 0.25 * b, 0.5 * r - 0.5 * b,
                        -0.25 * r + 0.5 * g - 0.25 * b], -1)


def rgb(c):
    y, co, cg = c.unbind(-1)
    return torch.stack([y + co - cg, y + cg, y - co - cg], -1)


def pixel_uv(H: int, W: int, device):
    """(H, W, 2) uv of the pixel centres, (i + 0.5) / size."""
    u = (torch.arange(W, device=device, dtype=torch.float32) + 0.5) / W
    v = (torch.arange(H, device=device, dtype=torch.float32) + 0.5) / H
    return torch.stack([u[None, :].expand(H, W), v[:, None].expand(H, W)],
                       -1)


def bilinear(img, uv):
    """``img`` (H, W, C) at uv (H', W', 2), texel centres at (i + 0.5) /
    size, the four taps clamped to the image."""
    H, W = img.shape[:2]
    x, y = uv[..., 0] * W - 0.5, uv[..., 1] * H - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0).unsqueeze(-1), (y - y0).unsqueeze(-1)

    def tap(xi, yi):
        return img[torch.clamp(yi.long(), 0, H - 1),
                   torch.clamp(xi.long(), 0, W - 1)]

    return (tap(x0, y0) * (1 - fx) + tap(x0 + 1, y0) * fx) * (1 - fy) \
        + (tap(x0, y0 + 1) * (1 - fx) + tap(x0 + 1, y0 + 1) * fx) * fy


def clip_to_box(c, lo, hi):
    """``c`` moved along the line to the box's centre until it lies in
    the box [lo, hi]: onto its surface from outside, unmoved inside."""
    centre = 0.5 * (lo + hi)
    d = centre - c
    d = torch.where(d.abs() < 1e-5, torch.full_like(d, 1e-5), d)
    enter = torch.minimum((lo - c) / d, (hi - c) / d).amax(-1, keepdim=True)
    return c + (centre - c) * torch.clamp(enter, 0.0, 1.0)


def resolve(current, history, motion, nearness, jitter, prev_jitter):
    """The resolved colour (H, W, 3) of ``current`` (H, W, 3) against
    ``history`` (the last resolved colour; None: no history, so the
    current colour alone), with the G-buffer's uv ``motion`` (H, W, 2),
    each pixel's ``nearness`` (H, W; larger nearer, as a reversed-Z
    depth: the motion taken is that of the first neighbour, row by row,
    of the largest) and the frame's and the previous frame's jitter in
    NDC units (2,)."""
    H, W = nearness.shape
    dev = current.device
    first = history is None
    if first:
        history = current
    best, near_motion = nearness, motion
    for dy, dx in NEIGHBOURS:
        z = shifted(nearness, dy, dx)
        closer = z > best
        near_motion = torch.where(closer.unsqueeze(-1),
                                  shifted(motion, dy, dx), near_motion)
        best = torch.maximum(z, best)

    j = torch.as_tensor(jitter, dtype=torch.float32, device=dev) * 0.5
    pj = torch.as_tensor(prev_jitter, dtype=torch.float32, device=dev) * 0.5
    prev_uv = pixel_uv(H, W, dev) - j - near_motion + pj

    mean = torch.zeros_like(current)
    square = torch.zeros_like(current)
    for dy, dx in NEIGHBOURS:
        c = ycocg(tonemap(shifted(current, dy, dx)))
        mean = mean + c
        square = square + c * c
    mean, square = mean / 9.0, square / 9.0
    sigma = torch.sqrt(torch.clamp(square - mean * mean, min=0.0))
    past = clip_to_box(ycocg(tonemap(bilinear(history, prev_uv))),
                       mean - BOX_SIGMAS * sigma, mean + BOX_SIGMAS * sigma)

    moved = torch.linalg.vector_norm(
        near_motion * torch.tensor([float(W), float(H)], device=dev), dim=-1)
    alpha = torch.clamp(ALPHA_MIN + ALPHA_PER_PIXEL * moved, ALPHA_MIN,
                        ALPHA_MAX)
    outside = ((prev_uv < 0.0) | (prev_uv > 1.0)).any(-1)
    alpha = torch.where(outside | first, torch.ones_like(alpha), alpha)
    now = ycocg(tonemap(current))
    return untonemap(rgb(past + (now - past) * alpha.unsqueeze(-1)))
