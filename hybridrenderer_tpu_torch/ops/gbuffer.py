"""Deferred G-buffer from the raster kernel's attribute image
(hybridrenderer_tpu/ops/gbuffer.py, the kernel-attribute path:
_gbuffer_from_kernel_attrs and _finish_gbuffer).

The planes are the reference's MRTs: albedo, world normal, material
params (roughness², metallic, ao, type/255), ObjectID, uv motion, linear
depth and its screen gradients, emissive, reversed-Z depth, world
position.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core import maths
from . import shade, texture


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

    @property
    def background(self):
        return self.object_id < 0

    def motion_plane(self):
        """The Motion RT layout: (motion.xy, linear depth, d lin-z/dx)."""
        return torch.cat([self.motion, self.linear_depth.unsqueeze(-1),
                          self.depth_grad[..., 0:1]], dim=-1)


def linearize_depth(depth, proj_inverse):
    """|(P^-1 (0, 0, d, 1)).z / w|."""
    z = proj_inverse[2, 2] * depth + proj_inverse[2, 3]
    w = proj_inverse[3, 2] * depth + proj_inverse[3, 3]
    return torch.abs(z / torch.where(torch.abs(w) < 1e-12,
                                     torch.full_like(w, 1e-12), w))


def screen_gradients(img):
    """Forward differences, clamped at the last row and column."""
    dx = torch.diff(img, dim=1, append=img[:, -1:])
    dy = torch.diff(img, dim=0, append=img[-1:, :])
    return dx, dy


def cutout_alpha_pass(scene, a):
    """The alpha test of the cut-out raster layer's winners, deferred:
    True where the pixel's texel alpha reaches its material's cutoff.
    ``a`` is that layer's (H, W, 40) attribute image: uv at 13:15, the
    packed material row at 16:32 (colour texture at 26, cutoff at 31)."""
    rgba = texture.sample_stack(scene.textures, a[..., 26].to(torch.int32),
                                a[..., 13:15], (1.0, 1.0, 1.0, 1.0))
    return rgba[..., 3] >= a[..., 31]


def build_gbuffer(vis, scene, cam, a) -> GBuffer:
    """Visibility buffer + the (H, W, 40) interpolated attribute image
    (channel layout: scene raster_rows lerped vertex pack, then its
    constants) → G-buffer. Elementwise only."""
    H, W = vis.depth.shape
    bg = vis.tri_id < 0
    world_pos = a[..., 0:3]
    prev_world = a[..., 3:6]
    world_n = maths.normalize(a[..., 6:9])
    uv = a[..., 13:15]
    mrow = a[..., 16:32]
    inst_id = a[..., 33].to(torch.int32)
    mp = shade.material_point_from_row(mrow, uv, scene.textures)
    if shade.uses_normal_map(scene.textures):
        world_t = torch.cat([maths.normalize(a[..., 9:12]), a[..., 12:13]],
                            dim=-1)
        shading_n = shade.apply_normal_map(
            scene.materials, a[..., 32].to(torch.int32), world_n, world_t,
            uv, scene.textures, nrm_tex_id=mrow[..., 13].to(torch.int32))
    else:
        shading_n = maths.normalize(world_n)

    # motion vectors from the unjittered current and previous clip pos
    vp = cam.proj @ cam.view
    prev_vp = cam.prev_proj @ cam.prev_view
    cur_clip = maths.transform_point_h(vp, world_pos)
    prev_clip = maths.transform_point_h(prev_vp, prev_world)

    def to_uv(clip):
        w = clip[..., 3]
        w = torch.where(torch.abs(w) < 1e-6, torch.full_like(w, 1e-6), w)
        return clip[..., :2] / w.unsqueeze(-1) * 0.5 + 0.5

    motion = to_uv(cur_clip) - to_uv(prev_clip)
    lin_depth = linearize_depth(vis.depth, cam.proj_inverse)
    lin_depth = torch.where(bg, torch.zeros_like(lin_depth), lin_depth)
    dzdx, dzdy = screen_gradients(lin_depth)

    shading_model = mp.material_type.to(torch.float32) / 255.0
    material_plane = torch.stack(
        [mp.roughness, mp.metallic, torch.ones_like(mp.roughness),
         shading_model], dim=-1)

    fg = (~bg).unsqueeze(-1)

    def mask(x):
        return torch.where(fg, x, torch.zeros_like(x))

    return GBuffer(
        albedo=mask(mp.colour),
        normal=mask(shading_n),
        material=mask(material_plane),
        object_id=torch.where(bg, -1, inst_id),
        motion=mask(motion),
        linear_depth=lin_depth,
        depth_grad=mask(torch.stack([dzdx, dzdy], dim=-1)),
        emissive=mask(mp.emission),
        depth=vis.depth,
        world_pos=mask(world_pos),
        uv=mask(uv),
    )
