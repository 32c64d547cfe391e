"""G-buffer cases for the one-launch G-buffer (ops/gbuffer_cuda.py, kernel
hr_gbuffer), shared by its CPU tests (tests/test_torch_gbuffer_stage.py)
and its card tests (tests/test_torch_cuda.py): a scene rastered through
K1 (its plain version on the CPU) from a moving camera, and the rows of
a window of the image. No JAX: the card tests run without it.

``unsplit_build_gbuffer`` is ``ops/gbuffer.py`` ``build_gbuffer`` as it
was before the kernel, verbatim on one device, kept as the oracle the
kernel's plain version is held to bit for bit; a window's planes are the
whole image's rows, as the row-sharded frame promises."""
import dataclasses
import types

import torch

from hybridrenderer_tpu_torch.core import maths
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.core.types import RenderFlags
from hybridrenderer_tpu_torch.graph import passes
from hybridrenderer_tpu_torch.ops import raster_cuda, shade
from hybridrenderer_tpu_torch.ops.gbuffer import GBuffer
from hybridrenderer_tpu_torch.ops.gbuffer_cuda import (linearize_depth,
                                                       screen_gradients)
from hybridrenderer_tpu_torch.scene import scene as scenes

from .torch_shade_cases import _all_slots_cube

CUBE = dict(distance=6.0, pitch=0.45, yaw=0.6, focal_point=(0, 0.75, 0))
STRESS = dict(distance=24.0, pitch=0.5, yaw=0.8, focal_point=(0, 2, 0))
CORNELL = dict(distance=8.0, pitch=0.1, yaw=0.2, focal_point=(0, 2.5, 0))


def _textured_stress():
    return scenes.stress_scene(num_objects=12, seed=3, textured=True,
                               tex_size=32)


# case → (host scene, width, height, camera, window (first row, rows) or
# None for the whole image)
CASES = {
    "untextured": (scenes.cornell_scene, 64, 48, CORNELL, None),
    "colour_slot": (_textured_stress, 64, 48, STRESS, None),
    "all_slots_normal_map": (_all_slots_cube, 64, 48, CUBE, None),
    "mostly_background": (scenes.cube_scene, 64, 48,
                          dict(CUBE, distance=40.0, pitch=-0.3), None),
    "w_near_zero": (scenes.cube_scene, 64, 48, CUBE, None),
    "row_window": (_textured_stress, 64, 48, STRESS, (16, 16)),
    "last_rows": (_textured_stress, 64, 48, STRESS, (35, 13)),
    "odd_size": (_all_slots_cube, 203, 117, CUBE, None),
}


@dataclasses.dataclass
class Case:
    scene: object      # SceneData on the device
    cam: object        # CameraState of tensors on the device
    tri_id: object     # (FH, W) i32, the whole image
    depth: object      # (FH, W) f32
    attrs: object      # (FH, W, 40) f32
    window: object     # (first row, rows) or None

    @property
    def rows(self):
        """The window's rows of the image: (first, end)."""
        if self.window is None:
            return 0, self.depth.shape[0]
        return self.window[0], self.window[0] + self.window[1]

    def planes_args(self):
        """``gbuffer_planes``' arguments for the window: its winners,
        depth and attributes, the scene, the camera and the row below
        (None at the image's last row)."""
        a, b = self.rows
        below = None if b == self.depth.shape[0] else (self.depth[b],
                                                       self.tri_id[b])
        return (self.tri_id[a:b], self.depth[a:b], self.attrs[a:b],
                self.scene, self.cam, below)


class HaloWindow:
    """The part of graph/passes.FrameContext ``build_gbuffer`` reads in a
    row window: ``halo`` pads the window's depth and winners with up to
    ``r`` rows of the whole image's above and below, as the row exchange
    does."""

    def __init__(self, case: Case):
        self.case = case

    def halo(self, r, depth, tri_id):
        c = self.case
        a, b = c.rows
        assert torch.equal(depth, c.depth[a:b])
        assert torch.equal(tri_id, c.tri_id[a:b])
        lo, hi = max(0, a - r), min(c.depth.shape[0], b + r)
        return [c.depth[lo:hi], c.tri_id[lo:hi]], a - lo


def _w_near_zero(attrs, cam, tri_id):
    """World positions of every fourth covered pixel moved onto the
    current and the previous view-projection's w = 0 plane, give or take
    a millionth, so the motion's w guard and its huge quotients show."""
    out = attrs.clone()
    covered = torch.nonzero(tri_id.reshape(-1) >= 0).reshape(-1)[::4]
    flat = out.reshape(-1, attrs.shape[-1])
    g = torch.Generator().manual_seed(7)
    offs = ((torch.rand(covered.shape[0], generator=g) - 0.5) * 2e-6).to(
        attrs.device).unsqueeze(-1)
    for lo, m in ((0, cam.proj @ cam.view),
                  (3, cam.prev_proj @ cam.prev_view)):
        p = flat[covered, lo:lo + 3]
        row = m[3, :3]
        w = p @ row + m[3, 3]
        flat[covered, lo:lo + 3] = p - ((w / (row @ row)).unsqueeze(-1)
                                        - offs) * row
    return out


def build(name, dev) -> Case:
    """The case's scene rastered on ``dev`` through K1 with the attribute
    ride-along, from the second step of an orbiting camera (so motion is
    not zero), jittered as the hybrid path rasters."""
    host_fn, W, H, cam_kw, window = CASES[name]
    data = host_fn().build(dev)
    cam = OrbitCamera(width=W, height=H, **cam_kw)
    cam.step(taa_enabled=True)
    cam.orbit(0.05, 0.02)
    cs = cam.step(taa_enabled=True).to(dev)
    settings = RenderSettings(width=W, height=H,
                              flags=RenderFlags.default_hybrid())
    _, (tris,) = passes._clip_scene(settings, data, cs, True)
    vis, attrs = raster_cuda.rasterize_binned(tris, W, H, data.raster_rows)
    if name == "w_near_zero":
        attrs = _w_near_zero(attrs, cs, vis.tri_id)
    return Case(data, cs, vis.tri_id, vis.depth, attrs, window)


def unsplit_build_gbuffer(vis, scene, cam, a) -> GBuffer:
    """ops/gbuffer.py build_gbuffer before the kernel, verbatim on one
    device (``window`` None)."""
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


def unsplit_planes(case: Case):
    """The oracle's planes of the case's window: the whole image's
    G-buffer, cropped to the window's rows → {name: plane}."""
    vis = types.SimpleNamespace(tri_id=case.tri_id, depth=case.depth)
    gb = unsplit_build_gbuffer(vis, case.scene, case.cam, case.attrs)
    a, b = case.rows
    return {f.name: getattr(gb, f.name)[a:b]
            for f in dataclasses.fields(GBuffer)}
