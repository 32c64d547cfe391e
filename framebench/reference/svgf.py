"""The reference's SVGF: temporal accumulation of a 1-spp signal through
the motion vectors, a 7 x 7 moments filter that estimates its variance,
and a variance-guided a-trous wavelet filter, edge-stopped by
luminance, normal and depth. Images are (H, W, C) float32; a
neighbour past the image's edge reads the edge pixel."""
from __future__ import annotations

import dataclasses

import torch

from .shading import luminance

ATROUS_TAPS = (3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)
MAX_HISTORY = 32.0


@dataclasses.dataclass
class Geometry:
    """The G-buffer planes SVGF reads: normal (H, W, 3), object (H, W)
    i64, linear depth z (H, W), its x gradient dzdx (H, W), motion
    (H, W, 2), albedo (H, W, 3)."""
    normal: torch.Tensor
    object_id: torch.Tensor
    z: torch.Tensor
    dzdx: torch.Tensor
    motion: torch.Tensor
    albedo: torch.Tensor


def _at(img, dy: int, dx: int):
    """out[y, x] = img[y + dy, x + dx], clamped to the image."""
    H, W = img.shape[:2]
    ys = torch.clamp(torch.arange(H, device=img.device) + dy, 0, H - 1)
    xs = torch.clamp(torch.arange(W, device=img.device) + dx, 0, W - 1)
    return img.index_select(0, ys).index_select(1, xs)


def _normal_weight(n, m, power: float):
    return torch.pow(torch.clamp((n * m).sum(-1), min=0.0), power)


def reproject(history, prev, cur: Geometry):
    """The history's bilinear footprint at each pixel's previous
    position (pixel centre minus the motion, in the previous image),
    each of its four texels kept only where it shows the same object,
    a normal within dot 0.95 and a depth within 5%. ``history`` (sig
    (H, W, 4), mom (H, W, 4)); ``prev`` the previous frame's Geometry
    → (signal (H, W, 4), m1, m2, length (H, W), weight (H, W))."""
    sig, mom = history
    H, W = cur.z.shape
    dev = cur.z.device
    cx = (torch.arange(W, device=dev, dtype=torch.float32) + 0.5) / W
    cy = (torch.arange(H, device=dev, dtype=torch.float32) + 0.5) / H
    px = (cx[None, :] - cur.motion[..., 0]) * W - 0.5
    py = (cy[:, None] - cur.motion[..., 1]) * H - 0.5
    inside = (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
    bx = torch.minimum(torch.clamp(torch.floor(px), min=0.0),
                       torch.tensor(W - 2.0, device=dev))
    by = torch.minimum(torch.clamp(torch.floor(py), min=0.0),
                       torch.tensor(H - 2.0, device=dev))
    fx, fy = px - bx, py - by
    bx, by = bx.long(), by.long()
    acc_sig = torch.zeros((H, W, 4), device=dev)
    acc_m = torch.zeros((H, W, 3), device=dev)
    acc_w = torch.zeros((H, W), device=dev)
    for oy, ox, w in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)),
                      (1, 0, (1 - fx) * fy), (1, 1, fx * fy)):
        y, x = by + oy, bx + ox
        same = inside & (prev.object_id[y, x] == cur.object_id) \
            & ((prev.normal[y, x] * cur.normal).sum(-1) >= 0.95) \
            & ((cur.z - prev.z[y, x]).abs() / (cur.z + 1e-6) <= 0.05)
        w = torch.where(same, w, torch.zeros_like(w))
        acc_sig += w.unsqueeze(-1) * sig[y, x]
        acc_m += w.unsqueeze(-1) * mom[y, x][..., [0, 1, 3]]
        acc_w += w
    return acc_sig, acc_m[..., 0], acc_m[..., 1], acc_m[..., 2], acc_w


def accumulate(signal, history, prev, cur: Geometry, demodulate: bool):
    """→ (accumulated signal, moments (m1, m2, variance, length)); with
    no ``history`` the signal itself and a length of 1."""
    if demodulate:
        signal = torch.cat([signal[..., :3]
                            / torch.clamp(cur.albedo, min=0.01),
                            signal[..., 3:]], dim=-1)
    luma = luminance(signal[..., :3])
    if history is None:
        return signal, torch.stack([luma, luma * luma,
                                    torch.zeros_like(luma),
                                    torch.ones_like(luma)], dim=-1)
    h_sig, h_m1, h_m2, h_len, wsum = reproject(history, prev, cur)
    found = wsum > 0.01
    ws = torch.clamp(wsum, min=1e-6)
    h_sig, h_m1, h_m2, h_len = h_sig / ws.unsqueeze(-1), h_m1 / ws, \
        h_m2 / ws, h_len / ws
    length = torch.where(found, torch.clamp(h_len + 1.0, max=MAX_HISTORY),
                         torch.ones_like(h_len))
    a = 1.0 / length
    out = torch.where(found.unsqueeze(-1),
                      h_sig + (signal - h_sig) * a.unsqueeze(-1), signal)
    m1 = torch.where(found, h_m1 + (luma - h_m1) * a, luma)
    m2 = torch.where(found, h_m2 + (luma * luma - h_m2) * a, luma * luma)
    return out, torch.stack([m1, m2, torch.clamp(m2 - m1 * m1, min=0.0),
                             length], dim=-1)


def moments_filter(signal, moments, cur: Geometry, phi_luma: float,
                   phi_normal: float):
    """7 x 7 edge-stopped mean of the colour and the moments → the
    signal with the variance (boosted where the history is shorter than
    4 frames) in its fourth channel; background pixels as they came."""
    luma = luminance(signal[..., :3])
    z = cur.z
    phi_z = torch.clamp(cur.dzdx, min=1e-8) * 3.0
    wsum = torch.zeros_like(z)
    rgb = torch.zeros_like(signal[..., :3])
    m = torch.zeros_like(signal[..., :2])
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            s = _at(signal, dy, dx)
            dist = float((dx * dx + dy * dy) ** 0.5)
            w = torch.exp(-(luma - luminance(s[..., :3])).abs() / phi_luma
                          - (z - _at(z, dy, dx)).abs()
                          / (phi_z * dist + 1e-6)) \
                * _normal_weight(cur.normal, _at(cur.normal, dy, dx),
                                 phi_normal)
            wsum = wsum + w
            rgb = rgb + s[..., :3] * w.unsqueeze(-1)
            m = m + _at(moments, dy, dx)[..., :2] * w.unsqueeze(-1)
    wsum = torch.clamp(wsum, min=1e-6).unsqueeze(-1)
    rgb, m = rgb / wsum, m / wsum
    var = torch.clamp(m[..., 1] - m[..., 0] * m[..., 0], min=0.0)
    length = moments[..., 3]
    var = torch.where(length < 4.0, var * (4.0 / torch.clamp(length,
                                                              min=1.0)), var)
    bg = (z == 0).unsqueeze(-1)
    return torch.where(bg, signal, torch.cat([rgb, var.unsqueeze(-1)], -1))


def atrous(signal, cur: Geometry, step: int, phi_luma: float,
           phi_normal: float):
    """One 5 x 5 a-trous step at ``step`` pixels: colour by the
    weights, variance by their squares; background (depth 0 or past
    1000) as it came."""
    z = cur.z
    luma = luminance(signal[..., :3])
    phi_l = phi_luma * torch.sqrt(torch.clamp(1e-10 + signal[..., 3],
                                              min=0.0)) + 1e-6
    phi_z = torch.clamp(cur.dzdx, min=1e-8) * float(step) + 1e-6
    c = ATROUS_TAPS[0] * ATROUS_TAPS[0]
    wsum = torch.full_like(z, c)
    rgb = signal[..., :3] * c
    var = signal[..., 3] * c
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            if dx == 0 and dy == 0:
                continue
            s = _at(signal, dy * step, dx * step)
            dist = float((dx * dx + dy * dy) ** 0.5)
            w = torch.exp(-(luma - luminance(s[..., :3])).abs() / phi_l
                          - (z - _at(z, dy * step, dx * step)).abs()
                          / (phi_z * dist)) \
                * _normal_weight(cur.normal,
                                 _at(cur.normal, dy * step, dx * step),
                                 phi_normal) \
                * (ATROUS_TAPS[abs(dx)] * ATROUS_TAPS[abs(dy)])
            wsum = wsum + w
            rgb = rgb + s[..., :3] * w.unsqueeze(-1)
            var = var + s[..., 3] * w * w
    out = torch.cat([rgb / wsum.unsqueeze(-1),
                     (var / (wsum * wsum)).unsqueeze(-1)], -1)
    bg = ((z == 0) | (z > 1000.0)).unsqueeze(-1)
    return torch.where(bg, signal, out)


def denoise(signal, history, prev, cur: Geometry, demodulate: bool,
            iterations: int, phi, store_dtype):
    """One chain over a frame → (denoised signal, the history it leaves:
    (the first a-trous step's output, the moments), both stored at
    ``store_dtype``). ``phi``: (moments luminance, a-trous luminance
    scale, normal power)."""
    acc, moments = accumulate(signal, history, prev, cur, demodulate)
    out = moments_filter(acc, moments, cur, phi[0], phi[2])
    kept = out
    for i in range(iterations):
        out = atrous(out, cur, 1 << i, phi[1], phi[2])
        if i == 0:
            kept = out
    if demodulate:
        out = torch.cat([out[..., :3] * cur.albedo, out[..., 3:]], dim=-1)
    return out, (kept.to(store_dtype).float(), moments.to(store_dtype).float())
