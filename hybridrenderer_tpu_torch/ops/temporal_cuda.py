"""SVGF temporal history fetch: kernel K3 and its plain version
(hybridrenderer_tpu/ops/temporal_pallas.py; the plain version follows
ops/svgf.py temporal_multi with gather="pixel").

``temporal_fetch`` returns, per pixel, an (H, W, 8) f32 image: the
validated bilinear history signal (4), moments m1 and m2, history
length, and the sum of the kept tap weights.
"""
from __future__ import annotations

import torch

from .. import native
from ..core import maths
from . import image as img_ops

KERNEL = native.KERNELS["temporal_fetch"]


def temporal_fetch(hist_signal, hist_moments, prev_normal, prev_depth,
                   prev_oid, motion_plane, normal, oid):
    """History (H, W, 4) signal and moments (bf16 or f32, the storage
    type); previous-frame normal (H, W, 3), linear depth (H, W) and
    object id (H, W) i32; current motion plane (H, W, 4), normal and
    object id → (H, W, 8) f32.

    CUDA tensors launch kernel K3, which replaces the TPU kernel
    temporal_pallas._kernel; CPU tensors take the plain version. On the
    card the kernel is bound by memory; see csrc/temporal.cu."""
    if normal.device.type == "cpu":
        return temporal_fetch_plain(hist_signal, hist_moments, prev_normal,
                                    prev_depth, prev_oid, motion_plane,
                                    normal, oid)
    if normal.device.type != "cuda":
        raise ValueError(f"temporal_fetch: unsupported device {normal.device}")
    dev = normal.device
    H, W = oid.shape
    if H < 2 or W < 2:
        raise ValueError("temporal_fetch needs at least 2x2 pixels")
    hdt = hist_signal.dtype
    if hdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"history dtype {hdt} is neither f32 nor bf16")
    native.check(hist_signal, "hist_signal", hdt, (H, W, 4), dev)
    native.check(hist_moments, "hist_moments", hdt, (H, W, 4), dev)
    native.check(prev_normal, "prev_normal", torch.float32, (H, W, 3), dev)
    native.check(prev_depth, "prev_depth", torch.float32, (H, W), dev)
    native.check(prev_oid, "prev_oid", torch.int32, (H, W), dev)
    native.check(motion_plane, "motion_plane", torch.float32, (H, W, 4), dev)
    native.check(normal, "normal", torch.float32, (H, W, 3), dev)
    native.check(oid, "oid", torch.int32, (H, W), dev)
    out = torch.empty((H, W, 8), dtype=torch.float32, device=dev)
    KERNEL.launch("hr_temporal_fetch", native.ptr(hist_signal),
                  native.ptr(hist_moments), int(hdt == torch.bfloat16),
                  native.ptr(prev_normal), native.ptr(prev_depth),
                  native.ptr(prev_oid), native.ptr(motion_plane),
                  native.ptr(normal), native.ptr(oid), H, W,
                  native.ptr(out))
    return out


def temporal_fetch_plain(hist_signal, hist_moments, prev_normal, prev_depth,
                         prev_oid, motion_plane, normal, oid):
    """Plain PyTorch version of kernel K3 (exact per-pixel footprint)."""
    KERNEL.note_plain(normal)
    H, W = oid.shape
    dev = normal.device
    uv = img_ops.pixel_uv_grid(H, W, dev)
    prev_pix = (uv - motion_plane[..., :2]) * uv.new_tensor([W, H]) - 0.5
    z = motion_plane[..., 2]
    base = torch.minimum(torch.clamp(torch.floor(prev_pix), min=0.0),
                         uv.new_tensor([W - 2, H - 2]))
    f = prev_pix - base
    fx, fy = f[..., 0], f[..., 1]
    bx, by = base[..., 0].long(), base[..., 1].long()
    footprint_ok = (prev_pix[..., 0] >= 0) & (prev_pix[..., 0] <= W - 1) & \
        (prev_pix[..., 1] >= 0) & (prev_pix[..., 1] <= H - 1)
    oid_c = oid.to(torch.float32)
    weights = ((1.0 - fx) * (1.0 - fy), fx * (1.0 - fy),
               (1.0 - fx) * fy, fx * fy)
    sig = hist_signal.to(torch.float32).reshape(H * W, 4)
    mom = hist_moments.to(torch.float32).reshape(H * W, 4)
    pn = prev_normal.reshape(H * W, 3)
    acc = [torch.zeros((H, W), device=dev) for _ in range(8)]
    for tap, w in enumerate(weights):
        q = (by + (tap >> 1)) * W + bx + (tap & 1)
        ok = footprint_ok & (prev_oid.reshape(-1)[q].to(torch.float32) == oid_c)
        ok = ok & (maths.dot(pn[q], normal) >= 0.95)
        ok = ok & (torch.abs(z - prev_depth.reshape(-1)[q]) / (z + 1e-6)
                   <= 0.05)
        w = torch.where(ok, w, torch.zeros_like(w))
        taps = (sig[q, 0], sig[q, 1], sig[q, 2], sig[q, 3], mom[q, 0],
                mom[q, 1], mom[q, 3])
        for c, val in enumerate(taps):
            acc[c] = acc[c] + w * val
        acc[7] = acc[7] + w
    return torch.stack(acc, dim=-1)
