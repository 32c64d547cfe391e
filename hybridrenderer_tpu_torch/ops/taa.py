"""Temporal anti-aliasing resolve (hybridrenderer_tpu/ops/taa.py, taa.comp):
3x3 velocity dilation toward the closest reversed-Z depth, jitter-
compensated reprojection, YCoCg with a firefly-suppressing tonemap, the
variance neighbourhood AABB with ray-box history clipping, and the
motion-adaptive blend, in three launches: ``taa_reproject`` (dilation,
reprojection, blend weight; ops/taa_cuda.py), the history fetch K5
(ops/temporal_cuda.window_sample, the per-pixel bilinear sample of the
reference's CPU path: no pixel loses its history to a tile window), and
``taa_resolve`` (box, clip, blend). K5 stays a launch of its own: it is
at its memory bound already, and its time is what the benchmark's K5
share reads.
"""
from __future__ import annotations

from . import taa_cuda
from .temporal_cuda import window_sample


def resolve(cur_color, history_color, motion, depth, jitter, prev_jitter,
            history_valid: bool, enabled: bool = True, row0: int = 0):
    """TAA resolve of (H, W, 3) colour against the (FH, W, 3) history of
    the whole image. ``motion`` is the G-buffer's (H, W, 2) uv motion,
    ``depth`` reversed-Z, jitters in NDC units (x 0.5 → uv). The current
    planes hold image rows ``row0`` on (default: the whole image); the
    3x3 neighbourhoods clamp at their edges."""
    if not enabled:
        return cur_color
    prev_uv, alpha = taa_cuda.taa_reproject(
        motion, depth, jitter, prev_jitter, history_valid, row0,
        history_color.shape[0])
    history = window_sample(history_color.contiguous(), prev_uv)
    return taa_cuda.taa_resolve(cur_color, history, alpha)
