"""A frame's camera for the reference: the traffic's matrices, worked
into what the frame reads, in float64 on the host."""
from __future__ import annotations

import numpy as np
import torch


class Camera:
    """``view, proj, prev_view, prev_proj, jitter, prev_jitter`` of one
    frame (the traffic's tuple) → the tensors the reference reads."""

    def __init__(self, view, proj, prev_view, prev_proj, jitter,
                 prev_jitter, device):
        del prev_jitter  # the hybrid frame's TAA-less passes never read it
        f64 = np.float64
        view, proj = np.asarray(view, f64), np.asarray(proj, f64)
        vp = proj @ view
        prev_vp = np.asarray(prev_proj, f64) @ np.asarray(prev_view, f64)

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        self.view_proj = t(vp)
        self.prev_view_proj = t(prev_vp)
        self.view_proj_inv = np.linalg.inv(vp)
        self.position_np = np.linalg.inv(view)[:3, 3]
        self.position = t(self.position_np)
        self.jitter = np.asarray(jitter, f64)
        # reversed-Z: proj[2, 2] = n / (f - n), proj[2, 3] = n f / (f - n)
        far = proj[2, 3] / proj[2, 2]
        self.near = proj[2, 2] * far / (1.0 + proj[2, 2])
        self.device = device

    def pixel_rays(self, height: int, width: int):
        """(H, W, 3) unit directions from the eye through each pixel
        centre, at the far plane (reversed-Z NDC depth 0)."""
        ys = (np.arange(height, dtype=np.float64) + 0.5) / height * 2 - 1
        xs = (np.arange(width, dtype=np.float64) + 0.5) / width * 2 - 1
        ndc = np.stack(np.broadcast_arrays(xs[None, :], ys[:, None],
                                           0.0, 1.0), axis=-1)
        h = ndc @ self.view_proj_inv.T
        far = h[..., :3] / h[..., 3:4]
        d = far - self.position_np
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return torch.as_tensor(d.astype(np.float32), device=self.device)
