"""The G-buffer planes from K1's visibility buffer and its (H, W, 40)
attribute image, as one CUDA kernel (``hr_gbuffer``, csrc/gbuffer.cu)
with its plain PyTorch version (the reference's
_gbuffer_from_kernel_attrs and _finish_gbuffer).

The kernel's branches follow only what its inputs show: which texture
slots a material binds (``TextureStack.slot_usage``, where the stack
holds textures) and whether the window has a row below. CUDA tensors
launch the kernel; CPU tensors take the plain version, which does the
float operations of the reference's G-buffer in its order, as the kernel
does.
"""
from __future__ import annotations

import ctypes
from typing import Any, NamedTuple

import torch

from .. import native
from ..core import maths
from . import shade, shade_cuda

KERNEL = native.KERNELS["gbuffer"]
ATTRS = 40      # channels of K1's attribute image


class Planes(NamedTuple):
    """The planes of a GBuffer but its depth, zero at background pixels."""
    albedo: Any      # (H, W, 3)
    normal: Any      # (H, W, 3) shading normal, world space
    material: Any    # (H, W, 4) roughness², metallic, 1, type/255
    object_id: Any   # (H, W) i32, -1 background
    motion: Any      # (H, W, 4) the Motion RT: motion.xy, lin z, d lin-z/dx
    depth_grad: Any  # (H, W, 2) (d lin-z/dx, d lin-z/dy)
    emissive: Any    # (H, W, 3)
    world_pos: Any   # (H, W, 3)
    uv: Any          # (H, W, 2)


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


def _view_projections(cam):
    """The unjittered current and previous view-projection products."""
    return cam.proj @ cam.view, cam.prev_proj @ cam.prev_view


def gbuffer_planes(tri_id, depth, a, scene, cam, below=None) -> Planes:
    """(H, W) winners ``tri_id`` (i32, -1 background) and reversed-Z
    ``depth``, the (H, W, 40) f32 attribute image ``a`` (channel layout:
    the scene's raster_rows lerped vertex pack, then its constants) →
    Planes. ``below`` (the next window's first row's (depth, tri_id),
    each (W,)) is the row under a row window's last; None on the image's
    last row, which clamps.

    CUDA tensors launch ``hr_gbuffer``; CPU tensors take the plain
    version."""
    if depth.device.type == "cpu":
        return gbuffer_planes_plain(tri_id, depth, a, scene, cam, below)
    if depth.device.type != "cuda":
        raise ValueError(f"gbuffer_planes: unsupported device "
                         f"{depth.device}")
    dev = depth.device
    H, W = depth.shape
    native.check(tri_id, "tri_id", torch.int32, (H, W), dev)
    native.check(depth, "depth", torch.float32, (H, W), dev)
    a = native.aligned(a.contiguous())    # float4 loads
    native.check(a, "attrs", torch.float32, (H, W, ATTRS), dev)
    if below is not None:
        below = tuple(x.contiguous() for x in below)
        native.check(below[0], "depth_below", torch.float32, (W,), dev)
        native.check(below[1], "tri_below", torch.int32, (W,), dev)
    vp, prev_vp = _view_projections(cam)
    pinv = cam.proj_inverse.contiguous()
    for m, name in ((vp, "vp"), (prev_vp, "prev_vp"),
                    (pinv, "proj_inverse")):
        native.check(m, name, torch.float32, (4, 4), dev)
    keep = []
    tex = shade_cuda.textures_arg(scene.textures, True, False, keep)

    def plane(*shape, dtype=torch.float32):
        return torch.empty((H, W, *shape), dtype=dtype, device=dev)

    out = Planes(albedo=plane(3), normal=plane(3), material=plane(4),
                 object_id=plane(dtype=torch.int32), motion=plane(4),
                 depth_grad=plane(2), emissive=plane(3), world_pos=plane(3),
                 uv=plane(2))
    KERNEL.launch(
        "hr_gbuffer", ctypes.byref(tex), native.ptr(a),
        native.ptr(tri_id), native.ptr(depth),
        None if below is None else native.ptr(below[1]),
        None if below is None else native.ptr(below[0]),
        native.ptr(vp), native.ptr(prev_vp), native.ptr(pinv), H, W,
        *(native.ptr(x) for x in out))
    del keep
    return out


def gbuffer_planes_plain(tri_id, depth, a, scene, cam,
                         below=None) -> Planes:
    """Plain PyTorch version of ``hr_gbuffer``."""
    KERNEL.note_plain(depth)
    H = depth.shape[0]
    bg = tri_id < 0
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
    vp, prev_vp = _view_projections(cam)
    cur_clip = maths.transform_point_h(vp, world_pos)
    prev_clip = maths.transform_point_h(prev_vp, prev_world)

    def to_uv(clip):
        w = clip[..., 3]
        w = torch.where(torch.abs(w) < 1e-6, torch.full_like(w, 1e-6), w)
        return clip[..., :2] / w.unsqueeze(-1) * 0.5 + 0.5

    motion = to_uv(cur_clip) - to_uv(prev_clip)

    def linear(d, tri):
        z = linearize_depth(d, cam.proj_inverse)
        return torch.where(tri < 0, torch.zeros_like(z), z)

    lin_depth = linear(depth, tri_id)
    z = lin_depth
    if below is not None:
        z = torch.cat([lin_depth, linear(*below).unsqueeze(0)])
    dzdx, dzdy = (g[:H] for g in screen_gradients(z))

    shading_model = mp.material_type.to(torch.float32) / 255.0
    material_plane = torch.stack(
        [mp.roughness, mp.metallic, torch.ones_like(mp.roughness),
         shading_model], dim=-1)

    fg = (~bg).unsqueeze(-1)

    def mask(x):
        return torch.where(fg, x, torch.zeros_like(x))

    depth_grad = mask(torch.stack([dzdx, dzdy], dim=-1))
    return Planes(
        albedo=mask(mp.colour),
        normal=mask(shading_n),
        material=mask(material_plane),
        object_id=torch.where(bg, -1, inst_id),
        motion=torch.cat([mask(motion), lin_depth.unsqueeze(-1),
                          depth_grad[..., 0:1]], dim=-1),
        depth_grad=depth_grad,
        emissive=mask(mp.emission),
        world_pos=mask(world_pos),
        uv=mask(uv),
    )
