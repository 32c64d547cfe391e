"""SVGF denoiser: temporal accumulation + variance-guided à-trous
filtering (hybridrenderer_tpu/ops/svgf.py).

The history fetch is kernel K3 (ops/temporal_cuda.py) and the spatial
filters are the K4 kernels (ops/stencil_cuda.py); the accumulation math
between them is elementwise PyTorch. Chaining matches the reference:
the first à-trous output becomes next frame's history signal, the
temporal moments are their own history, and history is stored as bf16
at ``bits=16``.

``svgf_phi`` = (phi luma of the moments filter, phi luma scale of
à-trous, normal power, unused), as the reference's shaders index it.
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
    def create(height, width, device="cpu"):
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
             use_albedo_demod: bool, history_valid: bool):
    """temporal.comp for one signal → (accumulated (H, W, 4),
    moments (H, W, 4))."""
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
        normal.contiguous(), object_id.contiguous())
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
                  configs, svgf_phi, history_valid: bool):
    """SVGF chains for K signals over one frame's geometry →
    [(denoised (H, W, 4), new SVGFSignalHistory, variance (H, W))] x K."""
    phi_l_moments, phi_l_atrous, phi_n = (float(x) for x in svgf_phi[:3])
    mp = gb_motion_plane.contiguous()
    normal = normal.contiguous()
    results = []
    for cur, hist, config in zip(cur_signals, histories, configs):
        signal, new_hist_signal, new_hist_moments = cur, hist.signal, \
            hist.moments
        if config.temporal_enabled:
            signal, new_hist_moments = temporal(
                cur, albedo, mp, normal, object_id, hist, prev_normal,
                prev_lin_depth, prev_object_id, config.use_albedo_demod,
                history_valid)
            # the reference then blurs the filtered moments' variance
            # (variance_blur) and feeds the result to nothing: à-trous
            # reads the variance from signal .a, and under jit the blur is
            # dead code, so the port does not run it
            signal, _ = stencil_cuda.filter_moments(
                signal.contiguous(), new_hist_moments.contiguous(), normal,
                mp, phi_l_moments, phi_n)
        if config.spatial_enabled:
            for i in range(config.atrous_iterations):
                signal = stencil_cuda.atrous(signal.contiguous(), normal, mp,
                                             1 << i, phi_l_atrous, phi_n)
                if i == 0:
                    new_hist_signal = signal
        store = torch.bfloat16 if config.bits == 16 else torch.float32
        results.append((
            combine(signal, albedo, config.use_albedo_demod),
            SVGFSignalHistory(signal=new_hist_signal.to(store),
                              moments=new_hist_moments.to(store)),
            signal[..., 3]))
    return results
