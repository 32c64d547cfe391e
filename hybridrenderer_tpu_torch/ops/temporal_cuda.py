"""History fetches: the SVGF temporal fetch, kernel K3, and the TAA
history fetch, kernel K5, each with its plain version
(hybridrenderer_tpu/ops/temporal_pallas.py; the plain versions follow
ops/svgf.py temporal_multi with gather="pixel" and ops/image.py
sample_bilinear).

``temporal_fetch`` returns, per pixel, an (H, W, 8) f32 image: the
validated bilinear history signal (4), moments m1 and m2, history
length, and the sum of the kept tap weights. ``reproject`` is the
reference's single-signal entry over it. ``window_sample`` samples an
(H, W, P) image bilinearly at uv points.
"""
from __future__ import annotations

import torch

from .. import native
from ..core import maths
from . import image as img_ops

KERNEL = native.KERNELS["temporal_fetch"]
KERNEL_SAMPLE = native.KERNELS["window_sample"]


def temporal_fetch(hist_signal, hist_moments, prev_normal, prev_depth,
                   prev_oid, motion_plane, normal, oid, row0: int = 0):
    """History (FH, W, 4) signal and moments (bf16 or f32, the storage
    type); previous-frame normal (FH, W, 3), linear depth (FH, W) and
    object id (FH, W) i32, all of the whole image; current motion plane
    (H, W, 4), normal and object id of image rows ``row0`` ..
    ``row0 + H - 1`` (by default H = FH and row0 0: the whole image) →
    (H, W, 8) f32.

    CUDA tensors launch kernel K3, which replaces the TPU kernel
    temporal_pallas._kernel; CPU tensors take the plain version. On the
    card the kernel is bound by memory; see csrc/temporal.cu."""
    if normal.device.type == "cpu":
        return temporal_fetch_plain(hist_signal, hist_moments, prev_normal,
                                    prev_depth, prev_oid, motion_plane,
                                    normal, oid, row0)
    if normal.device.type != "cuda":
        raise ValueError(f"temporal_fetch: unsupported device {normal.device}")
    dev = normal.device
    H, W = oid.shape
    FH = hist_signal.shape[0]
    if FH < 2 or W < 2:
        raise ValueError("temporal_fetch needs at least 2x2 pixels")
    if not 0 <= row0 <= FH - H:
        raise ValueError(f"temporal_fetch: rows {row0}..{row0 + H - 1} lie "
                         f"outside the {FH}-row history")
    hdt = hist_signal.dtype
    if hdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"history dtype {hdt} is neither f32 nor bf16")
    native.check(hist_signal, "hist_signal", hdt, (FH, W, 4), dev)
    native.check(hist_moments, "hist_moments", hdt, (FH, W, 4), dev)
    native.check(prev_normal, "prev_normal", torch.float32, (FH, W, 3), dev)
    native.check(prev_depth, "prev_depth", torch.float32, (FH, W), dev)
    native.check(prev_oid, "prev_oid", torch.int32, (FH, W), dev)
    native.check(motion_plane, "motion_plane", torch.float32, (H, W, 4), dev)
    native.check(normal, "normal", torch.float32, (H, W, 3), dev)
    native.check(oid, "oid", torch.int32, (H, W), dev)
    out = torch.empty((H, W, 8), dtype=torch.float32, device=dev)
    KERNEL.launch("hr_temporal_fetch", native.ptr(hist_signal),
                  native.ptr(hist_moments), int(hdt == torch.bfloat16),
                  native.ptr(prev_normal), native.ptr(prev_depth),
                  native.ptr(prev_oid), native.ptr(motion_plane),
                  native.ptr(normal), native.ptr(oid), H, W, row0, FH,
                  native.ptr(out))
    return out


def temporal_fetch_plain(hist_signal, hist_moments, prev_normal, prev_depth,
                         prev_oid, motion_plane, normal, oid, row0: int = 0):
    """Plain PyTorch version of kernel K3 (exact per-pixel footprint)."""
    KERNEL.note_plain(normal)
    H, W = oid.shape
    FH = hist_signal.shape[0]
    dev = normal.device
    uv = img_ops.pixel_uv_grid(H, W, dev, row0, FH)
    prev_pix = (uv - motion_plane[..., :2]) * uv.new_tensor([W, FH]) - 0.5
    z = motion_plane[..., 2]
    base = torch.minimum(torch.clamp(torch.floor(prev_pix), min=0.0),
                         uv.new_tensor([W - 2, FH - 2]))
    f = prev_pix - base
    fx, fy = f[..., 0], f[..., 1]
    bx, by = base[..., 0].long(), base[..., 1].long()
    footprint_ok = (prev_pix[..., 0] >= 0) & (prev_pix[..., 0] <= W - 1) & \
        (prev_pix[..., 1] >= 0) & (prev_pix[..., 1] <= FH - 1)
    oid_c = oid.to(torch.float32)
    weights = ((1.0 - fx) * (1.0 - fy), fx * (1.0 - fy),
               (1.0 - fx) * fy, fx * fy)
    sig = hist_signal.to(torch.float32).reshape(FH * W, 4)
    mom = hist_moments.to(torch.float32).reshape(FH * W, 4)
    pn = prev_normal.reshape(FH * W, 3)
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


def reproject(hpack_pm, motion, normal, z, oid):
    """The reference's single-signal entry (temporal_pallas.reproject)
    over K3. ``hpack_pm`` (12, H, W) f32 is the legacy plane-major pack
    sig0..3, m1, m2, hlen, prev nx, ny, nz, prev linear depth, prev
    object id; ``motion`` (H, W, 2) the uv motion the footprint follows;
    ``normal`` (H, W, 3), ``z`` (H, W) and ``oid`` (H, W) the current
    frame's. → (hist_sig (H, W, 4), hist_mom (H, W, 2), hist_len (H, W),
    wsum (H, W)), unnormalized as the reference returns them."""
    H, W = z.shape
    pm = hpack_pm.to(torch.float32)
    hist_signal = pm[0:4].permute(1, 2, 0)
    hist_moments = torch.stack([pm[4], pm[5], torch.zeros_like(pm[4]),
                                pm[6]], dim=-1)
    motion_plane = torch.cat([motion, z.unsqueeze(-1),
                              torch.zeros_like(z).unsqueeze(-1)], dim=-1)
    f = temporal_fetch(hist_signal.contiguous(), hist_moments.contiguous(),
                       pm[7:10].permute(1, 2, 0).contiguous(),
                       pm[10].contiguous(), pm[11].to(torch.int32),
                       motion_plane.contiguous(), normal.contiguous(),
                       oid.to(torch.int32).contiguous())
    return f[..., 0:4], f[..., 4:6], f[..., 6], f[..., 7]


def window_sample(image, uv):
    """Bilinear sample of an (H, W, P) f32 image at uv (..., 2) in
    [0, 1]^2 (pixel centres at (i + 0.5) / N), clamp-to-edge taps →
    (..., P) f32.

    CUDA tensors launch kernel K5, which replaces the TPU kernel
    temporal_pallas._sample_kernel; CPU tensors take the plain version.
    On the card the kernel is bound by memory; see csrc/temporal.cu.
    Views of any alignment are taken (uv is read in whole 8-byte loads
    where it is aligned for them)."""
    if uv.device.type == "cpu":
        return window_sample_plain(image, uv)
    if uv.device.type != "cuda":
        raise ValueError(f"window_sample: unsupported device {uv.device}")
    dev = uv.device
    if image.dim() != 3:
        raise ValueError(f"image: shape {tuple(image.shape)}, expected "
                         f"(H, W, P)")
    H, W, P = image.shape
    if H < 1 or W < 1:
        raise ValueError(f"window_sample: empty image {tuple(image.shape)}")
    native.check(image, "image", torch.float32, (H, W, P), dev)
    native.check(uv, "uv", torch.float32, (*uv.shape[:-1], 2), dev)
    Q = uv.numel() // 2
    out = torch.empty((*uv.shape[:-1], P), dtype=torch.float32, device=dev)
    KERNEL_SAMPLE.launch("hr_window_sample", native.ptr(image), H, W, P,
                         native.ptr(uv), Q, native.ptr(out))
    return out


def window_sample_plain(image, uv):
    """Plain PyTorch version of kernel K5 (ops/image.py sample_bilinear)."""
    KERNEL_SAMPLE.note_plain(uv)
    H, W = image.shape[:2]
    x = uv[..., 0] * W - 0.5
    y = uv[..., 1] * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0).unsqueeze(-1)
    fy = (y - y0).unsqueeze(-1)

    def tap(xi, yi):
        return image[torch.clamp(yi, 0, H - 1).long(),
                     torch.clamp(xi, 0, W - 1).long()]

    c00 = tap(x0, y0)
    c10 = tap(x0 + 1.0, y0)
    c01 = tap(x0, y0 + 1.0)
    c11 = tap(x0 + 1.0, y0 + 1.0)
    return (c00 * (1.0 - fx) + c10 * fx) * (1.0 - fy) + \
        (c01 * (1.0 - fx) + c11 * fx) * fy
