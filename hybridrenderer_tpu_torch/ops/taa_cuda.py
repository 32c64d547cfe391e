"""TAA's resolve (taa.comp) in two stages around the history fetch K5,
each a CUDA kernel with its plain PyTorch version:

* ``taa_reproject`` (kernel ``hr_taa_reproject``): the velocity dilation
  (the motion of the 3x3 neighbour closest in reversed-Z depth), the
  jitter-compensated reprojection to ``prev_uv`` and the blend weight
  ``alpha`` (1 off screen and with no valid history);
* ``window_sample`` (K5, ops/temporal_cuda.py): the history's bilinear
  sample at ``prev_uv``, unchanged;
* ``taa_resolve`` (kernel ``hr_taa_resolve``): the YCoCg variance box
  of the tonemapped 3x3 neighbourhood, the ray-box clip of the sample
  toward it, the blend and the untonemap.

Each stage's branches follow only what its inputs show: the planes'
height against the history's ``full_height``, ``row0`` and
``history_valid``. CUDA tensors launch the kernels; CPU tensors take the
plain versions, which do the float operations of the reference's
resolve in its order, as the kernels do (csrc/taa.cu).
"""
from __future__ import annotations

import torch

from .. import native
from ..core import maths
from . import image as img_ops

KERNEL_REPROJECT = native.KERNELS["taa_reproject"]
KERNEL_RESOLVE = native.KERNELS["taa_resolve"]


def _rgb_to_ycocg(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return torch.stack([0.25 * r + 0.5 * g + 0.25 * b, 0.5 * r - 0.5 * b,
                        -0.25 * r + 0.5 * g - 0.25 * b], dim=-1)


def _ycocg_to_rgb(c):
    y, co, cg = c[..., 0], c[..., 1], c[..., 2]
    return torch.stack([y + co - cg, y + cg, y - co - cg], dim=-1)


def _tonemap(c):
    c = torch.where(torch.isfinite(c), c, torch.zeros_like(c))
    c = torch.clamp(c, min=0.0)
    return c / (1.0 + c.amax(dim=-1, keepdim=True))


def _untonemap(c):
    lum = c.amax(dim=-1, keepdim=True)
    return c / torch.clamp(1.0 - lum, min=0.0001)


def _clip_history(history, box_min, box_max):
    """Ray-box clip of history toward the box centre (taa.comp:49-67)."""
    filtered = (box_min + box_max) * 0.5
    ray_dir = filtered - history
    ray_dir = torch.where(torch.abs(ray_dir) < 1e-5,
                          torch.full_like(ray_dir, 1e-5), ray_dir)
    inv = 1.0 / ray_dir
    t_min = (box_min - history) * inv
    t_max = (box_max - history) * inv
    enter = torch.minimum(t_min, t_max)
    t = torch.clamp(enter.amax(dim=-1, keepdim=True), 0.0, 1.0)
    return history + (filtered - history) * t


def taa_reproject(motion, depth, jitter, prev_jitter, history_valid: bool,
                  row0: int, full_height: int):
    """(H, W, 2) uv motion (any strides), (H, W) reversed-Z depth of image
    rows ``row0`` .. ``row0 + H - 1`` of an image ``full_height`` rows
    tall; the (2,) NDC jitters → (prev_uv (H, W, 2), alpha (H, W)), f32.

    CUDA tensors launch ``hr_taa_reproject``; CPU tensors take the plain
    version."""
    if depth.device.type == "cpu":
        return taa_reproject_plain(motion, depth, jitter, prev_jitter,
                                   history_valid, row0, full_height)
    if depth.device.type != "cuda":
        raise ValueError(f"taa_reproject: unsupported device {depth.device}")
    dev = depth.device
    H, W = depth.shape
    if motion.stride(-1) != 1:
        motion = motion.contiguous()
    depth, jitter, prev_jitter = (x.contiguous()
                                  for x in (depth, jitter, prev_jitter))
    if motion.dtype != torch.float32 or motion.shape != (H, W, 2) \
            or motion.device != dev:
        raise ValueError(f"motion: {motion.dtype} {tuple(motion.shape)} on "
                         f"{motion.device}, expected f32 ({H}, {W}, 2)")
    native.check(depth, "depth", torch.float32, (H, W), dev)
    native.check(jitter, "jitter", torch.float32, (2,), dev)
    native.check(prev_jitter, "prev_jitter", torch.float32, (2,), dev)
    prev_uv = torch.empty((H, W, 2), dtype=torch.float32, device=dev)
    alpha = torch.empty((H, W), dtype=torch.float32, device=dev)
    KERNEL_REPROJECT.launch(
        "hr_taa_reproject", native.ptr(depth), native.ptr(motion),
        motion.stride(0), motion.stride(1), native.ptr(jitter),
        native.ptr(prev_jitter), H, W, row0, full_height,
        int(history_valid), native.ptr(prev_uv), native.ptr(alpha))
    return prev_uv, alpha


def taa_reproject_plain(motion, depth, jitter, prev_jitter,
                        history_valid: bool, row0: int, full_height: int):
    """Plain PyTorch version of ``hr_taa_reproject``."""
    KERNEL_REPROJECT.note_plain(depth)
    H, W = depth.shape
    FH = full_height
    uv = img_ops.pixel_uv_grid(H, W, depth.device, row0, FH)

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

    # 5. (the weight of) the motion-adaptive blend
    off = (prev_uv[..., 0] < 0.0) | (prev_uv[..., 0] > 1.0) \
        | (prev_uv[..., 1] < 0.0) | (prev_uv[..., 1] > 1.0)
    size = maths.constant((float(W), float(FH)), uv.device)
    motion_len = torch.linalg.vector_norm(best_motion * size, dim=-1)
    alpha = torch.clamp(0.1 + motion_len * 0.1, 0.1, 0.9)
    alpha = torch.where(off, torch.ones_like(alpha), alpha)
    if not history_valid:
        alpha = torch.ones_like(alpha)
    return prev_uv, alpha


def taa_resolve(cur_color, history, alpha):
    """(H, W, 3) colour, the (H, W, 3) history sampled at each pixel's
    prev_uv and the (H, W) blend weight → the (H, W, 3) resolved colour.
    The 3x3 neighbourhoods clamp at the edges of the planes.

    CUDA tensors launch ``hr_taa_resolve``; CPU tensors take the plain
    version."""
    if cur_color.device.type == "cpu":
        return taa_resolve_plain(cur_color, history, alpha)
    if cur_color.device.type != "cuda":
        raise ValueError(f"taa_resolve: unsupported device "
                         f"{cur_color.device}")
    dev = cur_color.device
    H, W = cur_color.shape[:2]
    cur_color, history, alpha = (x.contiguous()
                                 for x in (cur_color, history, alpha))
    native.check(cur_color, "cur_color", torch.float32, (H, W, 3), dev)
    native.check(history, "history", torch.float32, (H, W, 3), dev)
    native.check(alpha, "alpha", torch.float32, (H, W), dev)
    out = torch.empty((H, W, 3), dtype=torch.float32, device=dev)
    KERNEL_RESOLVE.launch("hr_taa_resolve", native.ptr(cur_color),
                          native.ptr(history), native.ptr(alpha), H, W,
                          native.ptr(out))
    return out


def taa_resolve_plain(cur_color, history, alpha):
    """Plain PyTorch version of ``hr_taa_resolve``."""
    KERNEL_RESOLVE.note_plain(cur_color)
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

    # 4. clip the sampled history
    hist_ycocg = _clip_history(_rgb_to_ycocg(_tonemap(history)), box_min,
                               box_max)

    # 5. motion-adaptive blend
    resolved = hist_ycocg + (cur_ycocg - hist_ycocg) * alpha.unsqueeze(-1)
    return _untonemap(_ycocg_to_rgb(resolved))
