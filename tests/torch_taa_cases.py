"""TAA resolve cases for the staged resolve (ops/taa_cuda.py around K5),
shared by its CPU tests (tests/test_torch_taa_stages.py) and its card
tests (tests/test_torch_cuda.py): HDR colour, a history, uv motion,
reversed-Z depth with ties, the jitters, and the row window. No JAX: the
card tests run without it.

``unsplit_resolve`` is ``ops/taa.py`` ``resolve`` as it was before the
resolve was split in two stages around K5, kept as the oracle the stages
are held to bit for bit."""
import numpy as np
import torch

from hybridrenderer_tpu_torch.core import maths
from hybridrenderer_tpu_torch.ops import image as img_ops
from hybridrenderer_tpu_torch.ops.taa_cuda import (_clip_history,
                                                   _rgb_to_ycocg, _tonemap,
                                                   _untonemap, _ycocg_to_rgb)
from hybridrenderer_tpu_torch.ops.temporal_cuda import window_sample

# case → (H, W, full height, row0, history_valid): a row window's planes
# hold one halo row above and below its rows
CASES = {
    "whole": (37, 52, 37, 0, True),
    "row_window": (18, 40, 48, 14, True),
    "no_history": (37, 52, 37, 0, False),
    "off_screen": (40, 48, 40, 0, True),
    "non_finite": (33, 45, 33, 0, True),
    "strided_motion": (37, 52, 37, 0, True),
    "odd_size": (117, 203, 117, 0, True),
}


def build(case, dev, seed=0):
    """The arguments of ``resolve`` for ``case`` on ``dev``: (cur_color,
    history_color, motion, depth, jitter, prev_jitter) and the keywords
    history_valid and row0."""
    H, W, FH, row0, valid = CASES[case]
    g = np.random.default_rng(seed + sorted(CASES).index(case))
    cur = (g.random((H, W, 3)) ** 3 * 4.0).astype(np.float32)
    hist = (g.random((FH, W, 3)) * 2.0).astype(np.float32)
    motion = (g.standard_normal((H, W, 4)) * 0.01).astype(np.float32)
    # depths on a coarse grid, so the dilation meets ties
    depth = (g.integers(0, 6, (H, W)) / 8.0).astype(np.float32)
    if case == "off_screen":
        # reprojection off every edge of the image
        motion[:, :3, 0] = 0.3
        motion[:, -3:, 0] = -0.3
        motion[:3, :, 1] = 0.3
        motion[-3:, :, 1] = -0.3
    if case == "non_finite":
        flat = cur.reshape(-1)
        idx = g.choice(flat.size, 60, replace=False)
        flat[idx[:15]] = np.inf
        flat[idx[15:30]] = -np.inf
        flat[idx[30:45]] = np.nan
        flat[idx[45:]] = -g.random(15).astype(np.float32)
        hist.reshape(-1)[g.choice(hist.size, 10, replace=False)] = np.inf
        depth[5, 7] = np.nan
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    m = t(motion)
    motion_arg = m[..., :2] if case == "strided_motion" else \
        m[..., :2].contiguous()
    jitter = t(np.array([0.01, -0.02], np.float32))
    prev_j = t(np.array([-0.015, 0.005], np.float32))
    return ((t(cur), t(hist), motion_arg, t(depth), jitter, prev_j),
            dict(history_valid=valid, row0=row0))


def unsplit_resolve(cur_color, history_color, motion, depth, jitter,
                    prev_jitter, history_valid: bool, enabled: bool = True,
                    row0: int = 0):
    """ops/taa.py resolve before its split around K5, verbatim."""
    if not enabled:
        return cur_color
    H, W = depth.shape
    FH = history_color.shape[0]
    dev = depth.device
    uv = img_ops.pixel_uv_grid(H, W, dev, row0, FH)

    # 1. velocity dilation: the motion of the 3x3-closest pixel
    best_d = best_motion = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            d = img_ops.shift(depth, dy, dx)
            m = img_ops.shift(motion, dy, dx)
            if best_d is None:
                best_d, best_motion = d, m
            else:
                best_motion = torch.where((d > best_d).unsqueeze(-1), m,
                                          best_motion)
                best_d = torch.maximum(d, best_d)

    # 2. reprojection with jitter compensation
    cur_j = jitter * 0.5
    prev_j = prev_jitter * 0.5
    prev_uv = uv - cur_j - best_motion + prev_j

    cur_ycocg = _rgb_to_ycocg(_tonemap(cur_color))

    # 3. neighbourhood statistics AABB
    m1 = torch.zeros_like(cur_ycocg)
    m2 = torch.zeros_like(cur_ycocg)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            c = _rgb_to_ycocg(_tonemap(img_ops.shift(cur_color, dy, dx)))
            m1 = m1 + c
            m2 = m2 + c * c
    mu = m1 / 9.0
    sigma = torch.sqrt(torch.clamp(m2 / 9.0 - mu * mu, min=0.0))
    box_min = mu - 1.5 * sigma
    box_max = mu + 1.5 * sigma

    # 4. sample (K5) and clip the history
    off = ((prev_uv[..., 0] < 0.0) | (prev_uv[..., 0] > 1.0)
           | (prev_uv[..., 1] < 0.0) | (prev_uv[..., 1] > 1.0)).unsqueeze(-1)
    history = window_sample(history_color.contiguous(), prev_uv.contiguous())
    hist_ycocg = _clip_history(_rgb_to_ycocg(_tonemap(history)), box_min,
                               box_max)

    # 5. motion-adaptive blend
    size = maths.constant((float(W), float(FH)), uv.device)
    motion_len = torch.linalg.vector_norm(best_motion * size, dim=-1)
    alpha = torch.clamp(0.1 + motion_len * 0.1, 0.1, 0.9).unsqueeze(-1)
    alpha = torch.where(off, torch.ones_like(alpha), alpha)
    if not history_valid:
        alpha = torch.ones_like(alpha)
    resolved = hist_ycocg + (cur_ycocg - hist_ycocg) * alpha
    return _untonemap(_ycocg_to_rgb(resolved))
