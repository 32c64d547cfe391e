"""SVGF denoiser: temporal accumulation + variance-guided à-trous
filtering (hybridrenderer_tpu/ops/svgf.py).

The history fetch is kernel K3 (ops/temporal_cuda.py) and the spatial
filters are the K4 kernels (ops/stencil_cuda.py); the accumulation math
between them is elementwise PyTorch. Chaining matches the reference:
the first à-trous output becomes next frame's history signal, the
temporal moments are their own history, and history is stored as bf16
at ``bits=16``.

``svgf_phi`` = (phi luma of the moments filter, phi luma scale of
à-trous, normal power, unused), as the reference's shaders index it:
four numbers, or a (4,) float32 tensor of the frame's row, which the K4
kernels read on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import stencil_cuda, temporal_cuda
from .shade import luminance


@dataclasses.dataclass
class SVGFSignalHistory:
    signal: Any   # (H, W, 4) first-atrous output of the previous frame
    moments: Any  # (H, W, 4) (m1, m2, var, history length)

    @staticmethod
    def create(height, width, device):
        z = torch.zeros((height, width, 4), dtype=torch.float32, device=device)
        return SVGFSignalHistory(signal=z, moments=z.clone())


@dataclasses.dataclass(frozen=True)
class SVGFConfig:
    prefix: str = "SVGF"
    atrous_iterations: int = 3
    temporal_enabled: bool = True
    spatial_enabled: bool = True
    use_albedo_demod: bool = False
    # history storage width: 32 (f32) or 16 (bf16)
    bits: int = 32


def temporal(cur, albedo, motion_plane, normal, object_id, history,
             prev_normal, prev_lin_depth, prev_object_id,
             use_albedo_demod: bool, history_valid: bool, row0: int = 0):
    """temporal.comp for one signal → (accumulated (H, W, 4),
    moments (H, W, 4)). The current planes hold image rows ``row0`` on,
    the history and previous-frame planes the whole image."""
    if use_albedo_demod:
        cur = torch.cat([cur[..., :3] / torch.clamp(albedo, min=0.01),
                         cur[..., 3:]], dim=-1)
    cur_luma = luminance(cur[..., :3])
    if not history_valid:
        moments = torch.stack([cur_luma, cur_luma * cur_luma,
                               torch.zeros_like(cur_luma),
                               torch.ones_like(cur_luma)], dim=-1)
        return cur, moments

    f = temporal_cuda.temporal_fetch(
        history.signal.contiguous(), history.moments.contiguous(),
        prev_normal.contiguous(), prev_lin_depth.contiguous(),
        prev_object_id.contiguous(), motion_plane.contiguous(),
        normal.contiguous(), object_id.contiguous(), row0)
    weight_sum = f[..., 7]
    valid = weight_sum > 0.01
    ws = torch.clamp(weight_sum, min=1e-6)
    hist_sig = f[..., 0:4] / ws.unsqueeze(-1)
    hist_mom = f[..., 4:6] / ws.unsqueeze(-1)
    hist_len = f[..., 6] / ws

    out_hlen = torch.where(valid, torch.clamp(hist_len + 1.0, max=32.0),
                           torch.ones_like(hist_len))
    alpha = 1.0 / out_hlen
    accum = torch.where(valid.unsqueeze(-1),
                        hist_sig + (cur - hist_sig) * alpha.unsqueeze(-1),
                        cur)
    m1 = torch.where(valid,
                     hist_mom[..., 0] + (cur_luma - hist_mom[..., 0]) * alpha,
                     cur_luma)
    m2 = torch.where(
        valid,
        hist_mom[..., 1] + (cur_luma * cur_luma - hist_mom[..., 1]) * alpha,
        cur_luma * cur_luma)
    var = torch.clamp(m2 - m1 * m1, min=0.0)
    return accum, torch.stack([m1, m2, var, out_hlen], dim=-1)


def combine(filtered, albedo, use_albedo_remod: bool):
    if not use_albedo_remod:
        return filtered
    return torch.cat([filtered[..., :3] * albedo, filtered[..., 3:]], dim=-1)


def denoise_multi(cur_signals, albedo, gb_motion_plane, normal, object_id,
                  histories, prev_normal, prev_lin_depth, prev_object_id,
                  configs, svgf_phi, history_valid: bool, window=None):
    """SVGF chains for K signals over one frame's geometry →
    [(denoised (H, W, 4), new SVGFSignalHistory, variance (H, W))] x K.

    ``window`` (graph/passes.FrameContext, or None for the whole image)
    says which image rows the planes hold: then the histories and
    previous-frame planes are its rows too, gathered whole for the
    reprojection, and each stencil runs on the rows with its radius of
    halo rows (filter_moments 3, an à-trous step 2 step)."""
    phi_l_moments, phi_l_atrous, phi_n = svgf_phi[0], svgf_phi[1], \
        svgf_phi[2]
    mp = gb_motion_plane.contiguous()
    normal = normal.contiguous()
    row0 = 0 if window is None else window.row0

    def windowed(r, fn, *images):
        if window is None:
            return fn(*images)
        return window.windowed(r, lambda _, *x: fn(*x), *images)

    if window is not None and history_valid and any(
            c.temporal_enabled for c in configs):
        prev_normal, prev_lin_depth, prev_object_id = window.gather(
            prev_normal, prev_lin_depth, prev_object_id)
    results = []
    for cur, hist, config in zip(cur_signals, histories, configs):
        signal, new_hist_signal, new_hist_moments = cur, hist.signal, \
            hist.moments
        if config.temporal_enabled:
            whole = hist
            if window is not None and history_valid:
                whole = SVGFSignalHistory(*window.gather(hist.signal,
                                                         hist.moments))
            signal, new_hist_moments = temporal(
                cur, albedo, mp, normal, object_id, whole, prev_normal,
                prev_lin_depth, prev_object_id, config.use_albedo_demod,
                history_valid, row0)
            # the reference then blurs the filtered moments' variance
            # (variance_blur) and feeds the result to nothing: à-trous
            # reads the variance from signal .a, and under jit the blur is
            # dead code, so the port does not run it
            signal, _ = windowed(
                3, lambda s, m, n, p: stencil_cuda.filter_moments(
                    s.contiguous(), m.contiguous(), n.contiguous(),
                    p.contiguous(), phi_l_moments, phi_n),
                signal, new_hist_moments, normal, mp)
        if config.spatial_enabled:
            for i in range(config.atrous_iterations):
                signal = windowed(
                    2 << i, lambda s, n, p, step=1 << i: stencil_cuda.atrous(
                        s.contiguous(), n.contiguous(), p.contiguous(), step,
                        phi_l_atrous, phi_n),
                    signal, normal, mp)
                if i == 0:
                    new_hist_signal = signal
        store = torch.bfloat16 if config.bits == 16 else torch.float32
        results.append((
            combine(signal, albedo, config.use_albedo_demod),
            SVGFSignalHistory(signal=new_hist_signal.to(store),
                              moments=new_hist_moments.to(store)),
            signal[..., 3]))
    return results
