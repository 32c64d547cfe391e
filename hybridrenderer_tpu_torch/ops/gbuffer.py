"""Deferred G-buffer from the raster kernel's attribute image
(hybridrenderer_tpu/ops/gbuffer.py, the kernel-attribute path:
_gbuffer_from_kernel_attrs and _finish_gbuffer), built in one launch
(ops/gbuffer_cuda.py, kernel ``hr_gbuffer``).

The planes are the reference's MRTs: albedo, world normal, material
params (roughness², metallic, ao, type/255), ObjectID, uv motion, linear
depth and its screen gradients, emissive, reversed-Z depth, world
position.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import gbuffer_cuda, texture


@dataclasses.dataclass
class GBuffer:
    albedo: Any          # (H, W, 3)
    normal: Any          # (H, W, 3) world space
    material: Any        # (H, W, 4) roughness², metallic, ao, type/255
    object_id: Any       # (H, W) i32, -1 background
    motion: Any          # (H, W, 2) uv-space motion (cur - prev)
    linear_depth: Any    # (H, W) view-space |z|
    depth_grad: Any      # (H, W, 2) (d lin-z/dx, d lin-z/dy)
    emissive: Any        # (H, W, 3)
    depth: Any           # (H, W) reversed-Z NDC
    world_pos: Any       # (H, W, 3)
    uv: Any              # (H, W, 2)
    # (H, W, 4) the Motion RT layout (motion.xy, linear depth, d lin-z/dx);
    # ``build_gbuffer`` writes it, and ``motion`` and ``linear_depth`` are
    # views of it. Made from those planes when not given.
    motion_rt: Any = None

    def __post_init__(self):
        if self.motion_rt is None:
            self.motion_rt = torch.cat(
                [self.motion, self.linear_depth.unsqueeze(-1),
                 self.depth_grad[..., 0:1]], dim=-1)

    @property
    def background(self):
        return self.object_id < 0

    def motion_plane(self):
        """The Motion RT layout: (motion.xy, linear depth, d lin-z/dx)."""
        return self.motion_rt


def cutout_alpha_pass(scene, a):
    """The alpha test of the cut-out raster layer's winners, deferred:
    True where the pixel's texel alpha reaches its material's cutoff.
    ``a`` is that layer's (H, W, 40) attribute image: uv at 13:15, the
    packed material row at 16:32 (colour texture at 26, cutoff at 31)."""
    rgba = texture.sample_stack(scene.textures, a[..., 26].to(torch.int32),
                                a[..., 13:15], (1.0, 1.0, 1.0, 1.0))
    return rgba[..., 3] >= a[..., 31]


def build_gbuffer(vis, scene, cam, a, window=None) -> GBuffer:
    """Visibility buffer + the (H, W, 40) interpolated attribute image
    (channel layout: scene raster_rows lerped vertex pack, then its
    constants) → G-buffer, one ``gbuffer_cuda.gbuffer_planes`` launch.
    Elementwise but for the depth gradients, which in a row window
    (``window``, graph/passes.FrameContext) read the next window's first
    row: its depth and winners come with the window's one exchange."""
    H = vis.depth.shape[0]
    below = None
    if window is not None:
        (depth, tri), top = window.halo(1, vis.depth, vis.tri_id)
        if depth.shape[0] > top + H:
            below = (depth[top + H], tri[top + H])
    p = gbuffer_cuda.gbuffer_planes(vis.tri_id, vis.depth, a, scene, cam,
                                    below)
    return GBuffer(
        albedo=p.albedo, normal=p.normal, material=p.material,
        object_id=p.object_id, motion=p.motion[..., 0:2],
        linear_depth=p.motion[..., 2], depth_grad=p.depth_grad,
        emissive=p.emissive, depth=vis.depth, world_pos=p.world_pos,
        uv=p.uv, motion_rt=p.motion)
