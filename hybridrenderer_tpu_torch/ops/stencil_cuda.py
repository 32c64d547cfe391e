"""SVGF spatial stencils: the three kernels of K4 and their plain
versions (hybridrenderer_tpu/ops/stencil_pallas.py; same contract as
there and as the jnp filters of ops/svgf.py).

* ``filter_moments``: 7x7 edge-stopping filter of colour and moments;
  the variance estimate, boosted where history is shorter than 4 frames.
* ``variance_blur``: 3x3 (1, 2, 1)² blur of the variance mixed half and
  half with the 3x3 maximum.
* ``atrous``: one 5x5 à-trous iteration at a step of 1, 2 or 4.

Borders clamp to the edge. Signals are (H, W, 4) rgb + variance,
moments (H, W, 4) (m1, m2, variance, history length), ``normal``
(H, W, 3), ``motion_plane`` (H, W, 4) with linear depth in .z and its
x-gradient in .w.
"""
from __future__ import annotations

import torch

from .. import native
from . import image as img_ops
from .shade import luminance

KERNELS = (native.KERNELS["filter_moments"], native.KERNELS["variance_blur"],
           native.KERNELS["atrous"])
_ATROUS_KW = (3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def _check_planes(dev, H, W, **planes):
    for name, (t, c) in planes.items():
        native.check(t, name, torch.float32, (H, W, c), dev)


def _scalar(x, dev):
    """A phi argument as a (1,) float32 tensor on ``dev`` that the kernel
    reads: a device value as it is, a host number as a fill (no copy
    from the host, so a captured frame may make one)."""
    if isinstance(x, torch.Tensor):
        native.check(x.reshape(1), "phi", torch.float32, (1,), dev)
        return x.reshape(1)
    return torch.full((1,), float(x), dtype=torch.float32, device=dev)


def _device(t, op):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: unsupported device {t.device}")
    return t.device.type


# ---------------------------------------------------------------------------
# filter_moments
# ---------------------------------------------------------------------------

def filter_moments(signal, moments, normal, motion_plane, phi_luma,
                   phi_normal):
    """→ (signal with variance in .a, moments with variance in .b).
    ``phi_luma`` and ``phi_normal``: numbers, or 0-d float32 tensors on
    the signal's device (the kernel reads them there).

    CUDA tensors launch the K4 kernel that replaces the TPU kernel
    stencil_pallas.filter_moments; CPU tensors take the plain version.
    On the card it reads its window once into shared memory and is bound
    by the issue of its 49 taps' arithmetic: an accurate exp and two IEEE
    divisions a tap, the pow of the normals' weight once per pixel pair;
    see csrc/stencil.cu."""
    if _device(signal, "filter_moments") == "cpu":
        return filter_moments_plain(signal, moments, normal, motion_plane,
                                    phi_luma, phi_normal)
    H, W = signal.shape[:2]
    _check_planes(signal.device, H, W, signal=(signal, 4),
                  moments=(moments, 4), normal=(normal, 3),
                  motion_plane=(motion_plane, 4))
    # the kernel reads signal as float4s and moments as float2s
    signal, moments = native.aligned(signal), native.aligned(moments)
    out_sig = torch.empty_like(signal)
    out_mom = torch.empty_like(moments)
    phi_l, phi_n = _scalar(phi_luma, signal.device), \
        _scalar(phi_normal, signal.device)
    KERNELS[0].launch("hr_filter_moments", native.ptr(signal),
                      native.ptr(moments), native.ptr(normal),
                      native.ptr(motion_plane), H, W, native.ptr(phi_l),
                      native.ptr(phi_n), native.ptr(out_sig),
                      native.ptr(out_mom))
    return out_sig, out_mom


def _normal_weight(normal, normal_p, phi_normal):
    ndot = (normal[..., 0] * normal_p[..., 0] + normal[..., 1] * normal_p[..., 1]
            + normal[..., 2] * normal_p[..., 2])
    return torch.pow(torch.clamp(ndot, min=0.0), phi_normal)


def filter_moments_plain(signal, moments, normal, motion_plane,
                         phi_luma, phi_normal):
    KERNELS[0].note_plain(signal)
    phi_luma, phi_normal = float(phi_luma), float(phi_normal)
    luma_c = luminance(signal[..., :3])
    z_c = motion_plane[..., 2]
    phi_z_base = torch.clamp(motion_plane[..., 3], min=1e-8) * 3.0
    sum_w = torch.zeros_like(luma_c)
    acc = [torch.zeros_like(luma_c) for _ in range(5)]
    for yy in range(-3, 4):
        for xx in range(-3, 4):
            p = img_ops.shift(signal, yy, xx)
            m = img_ops.shift(moments, yy, xx)
            w_n = _normal_weight(normal, img_ops.shift(normal, yy, xx),
                                 phi_normal)
            dist = float((xx * xx + yy * yy) ** 0.5)
            w_z = torch.abs(z_c - img_ops.shift(z_c, yy, xx)) / \
                (phi_z_base * dist + 1e-6)
            w_l = torch.abs(luma_c - luminance(p[..., :3])) / phi_luma
            w = torch.exp(-w_l - w_z) * w_n
            sum_w = sum_w + w
            for i, v in enumerate((p[..., 0], p[..., 1], p[..., 2],
                                   m[..., 0], m[..., 1])):
                acc[i] = acc[i] + v * w
    sum_w = torch.clamp(sum_w, min=1e-6)
    m1 = acc[3] / sum_w
    m2 = acc[4] / sum_w
    variance = torch.clamp(m2 - m1 * m1, min=0.0)
    hlen = moments[..., 3]
    variance = torch.where(hlen < 4.0,
                           variance * (4.0 / torch.clamp(hlen, min=1.0)),
                           variance)
    bg = z_c == 0.0
    variance = torch.where(bg, signal[..., 3], variance)
    rgb = torch.stack([acc[0] / sum_w, acc[1] / sum_w, acc[2] / sum_w], -1)
    rgb = torch.where(bg.unsqueeze(-1), signal[..., :3], rgb)
    out_signal = torch.cat([rgb, variance.unsqueeze(-1)], dim=-1)
    out_moments = torch.stack([m1, m2, variance, hlen], dim=-1)
    return out_signal, out_moments


# ---------------------------------------------------------------------------
# variance_blur
# ---------------------------------------------------------------------------

def variance_blur(moments):
    """→ moments with .b replaced by the blurred/max variance mix.

    CUDA tensors launch the K4 kernel that replaces the TPU kernel
    stencil_pallas.variance_blur; CPU tensors take the plain version.
    On the card it is bound by memory (9 cached reads and 32 B of
    output per pixel); see csrc/stencil.cu."""
    if _device(moments, "variance_blur") == "cpu":
        return variance_blur_plain(moments)
    H, W = moments.shape[:2]
    _check_planes(moments.device, H, W, moments=(moments, 4))
    out = torch.empty_like(moments)
    KERNELS[1].launch("hr_variance_blur", native.ptr(moments), H, W,
                      native.ptr(out))
    return out


def variance_blur_plain(moments):
    KERNELS[1].note_plain(moments)
    var = moments[..., 2]
    k1 = (1.0, 2.0, 1.0)
    blurred = torch.zeros_like(var)
    vmax = torch.full_like(var, -float("inf"))
    for yy in (-1, 0, 1):
        for xx in (-1, 0, 1):
            v = img_ops.shift(var, yy, xx)
            blurred = blurred + v * (k1[xx + 1] * k1[yy + 1])
            vmax = torch.maximum(vmax, v)
    mixed = 0.5 * (blurred / 16.0) + 0.5 * vmax
    return torch.cat([moments[..., :2], mixed.unsqueeze(-1),
                      moments[..., 3:]], dim=-1)


# ---------------------------------------------------------------------------
# atrous
# ---------------------------------------------------------------------------

def atrous(signal, normal, motion_plane, step: int, phi_luma_scale,
           phi_normal):
    """One 5x5 à-trous iteration; variance rides in signal .a and is
    filtered with w². The phis as for ``filter_moments``.

    CUDA tensors launch the K4 kernel that replaces the TPU kernel
    stencil_pallas.atrous; CPU tensors take the plain version. On the
    card it reads its window once into shared memory and is bound by the
    issue of its 24 taps' arithmetic: an accurate exp and two IEEE
    divisions a tap, the pow of the normals' weight once per pixel pair;
    background pixels take no taps; see csrc/stencil.cu."""
    if _device(signal, "atrous") == "cpu":
        return atrous_plain(signal, normal, motion_plane, step,
                            phi_luma_scale, phi_normal)
    H, W = signal.shape[:2]
    _check_planes(signal.device, H, W, signal=(signal, 4),
                  normal=(normal, 3), motion_plane=(motion_plane, 4))
    signal = native.aligned(signal)   # read as float4s
    out = torch.empty_like(signal)
    phi_l, phi_n = _scalar(phi_luma_scale, signal.device), \
        _scalar(phi_normal, signal.device)
    KERNELS[2].launch("hr_atrous", native.ptr(signal), native.ptr(normal),
                      native.ptr(motion_plane), H, W, int(step),
                      native.ptr(phi_l), native.ptr(phi_n), native.ptr(out))
    return out


def atrous_plain(signal, normal, motion_plane, step: int,
                 phi_luma_scale, phi_normal):
    KERNELS[2].note_plain(signal)
    phi_luma_scale, phi_normal = float(phi_luma_scale), float(phi_normal)
    kw = _ATROUS_KW
    luma_c = luminance(signal[..., :3])
    var_c = signal[..., 3]
    z_c = motion_plane[..., 2]
    phi_luma = phi_luma_scale * torch.sqrt(
        torch.clamp(1e-10 + var_c, min=0.0)) + 1e-6
    phi_z_base = torch.clamp(motion_plane[..., 3], min=1e-8) * float(step) \
        + 1e-6
    w_center = kw[0] * kw[0]
    sum_w = torch.full_like(luma_c, w_center)
    acc = [signal[..., i] * w_center for i in range(3)]
    acc_v = var_c * w_center
    for yy in range(-2, 3):
        for xx in range(-2, 3):
            if xx == 0 and yy == 0:
                continue
            p = img_ops.shift(signal, yy * step, xx * step)
            w_n = _normal_weight(
                normal, img_ops.shift(normal, yy * step, xx * step),
                phi_normal)
            dist = float((xx * xx + yy * yy) ** 0.5)
            w_z = torch.abs(
                z_c - img_ops.shift(z_c, yy * step, xx * step)) / \
                (phi_z_base * dist)
            w_l = torch.abs(luma_c - luminance(p[..., :3])) / phi_luma
            w = torch.exp(-w_l - w_z) * w_n * (kw[abs(xx)] * kw[abs(yy)])
            sum_w = sum_w + w
            for i in range(3):
                acc[i] = acc[i] + p[..., i] * w
            acc_v = acc_v + p[..., 3] * w * w
    out = torch.stack([acc[0] / sum_w, acc[1] / sum_w, acc[2] / sum_w,
                       acc_v / (sum_w * sum_w)], dim=-1)
    bg = (z_c == 0.0) | (z_c > 1000.0)
    return torch.where(bg.unsqueeze(-1), signal, out)
