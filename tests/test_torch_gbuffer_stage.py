"""The one-launch G-buffer (ops/gbuffer_cuda.py, kernel hr_gbuffer) against
the plain PyTorch G-buffer it replaced, bit for bit, on the CPU: no
texture, the colour slot only, all four slots with a normal map, a mostly
empty image, world positions on the clip plane w = 0, a row window with a
row below and one at the image's last row, and a size that cuts the
kernel's blocks."""
import dataclasses
import types

import pytest
import torch

from hybridrenderer_tpu_torch import native
from hybridrenderer_tpu_torch.ops import gbuffer, gbuffer_cuda, texture

from .torch_gbuffer_cases import CASES, HaloWindow, build, unsplit_planes


def _equal(a, b, what):
    """Bit for bit, NaN where NaN."""
    assert a.dtype == b.dtype and a.shape == b.shape, what
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                               msg=what)


def _check_case(case, c):
    """The case is what its name says."""
    tex = c.scene.textures
    a, b = c.rows
    bg = (c.tri_id[a:b] < 0).float().mean()
    if case == "untextured":
        assert not texture.has_textures(tex)
    if case == "colour_slot":
        assert tex.slot_usage == (True, False, False, False)
    if case in ("all_slots_normal_map", "odd_size"):
        assert tex.slot_usage == (True, True, True, True)
    if case == "mostly_background":
        assert 0.9 < bg < 1.0
    else:
        assert bg < 0.5
    if case == "w_near_zero":
        vp = c.cam.proj @ c.cam.view
        w = c.attrs[..., 0:3] @ vp[3, :3] + vp[3, 3]
        fg = c.tri_id >= 0
        assert (w[fg].abs() < 1e-6).sum() > 20
    if case == "row_window":
        assert 0 < a and b < c.depth.shape[0]
    if case == "last_rows":
        assert b == c.depth.shape[0]
    if case == "odd_size":
        assert (b - a) * c.depth.shape[1] % 128 != 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_planes_equal_unsplit_gbuffer(case):
    c = build(case, "cpu")
    _check_case(case, c)
    want = unsplit_planes(c)
    planes = gbuffer_cuda.gbuffer_planes_plain(*c.planes_args())
    for name in gbuffer_cuda.Planes._fields:
        _equal(getattr(planes, name),
               want["motion_rt" if name == "motion" else name], name)

    # the G-buffer as the pass builds it, the row below through the halo
    a, b = c.rows
    vis = types.SimpleNamespace(tri_id=c.tri_id[a:b], depth=c.depth[a:b])
    gb = gbuffer.build_gbuffer(vis, c.scene, c.cam, c.attrs[a:b],
                               window=None if c.window is None
                               else HaloWindow(c))
    for f in dataclasses.fields(gbuffer.GBuffer):
        _equal(getattr(gb, f.name), want[f.name], f.name)
    # motion_plane() is the Motion RT the kernel writes, whose views are
    # the motion and linear depth: the concatenation it replaced
    rt = gb.motion_plane()
    assert rt is gb.motion_rt
    _equal(rt, torch.cat([gb.motion, gb.linear_depth.unsqueeze(-1),
                          gb.depth_grad[..., 0:1]], dim=-1), "motion_plane")
    assert gb.motion.data_ptr() == rt.data_ptr()
    assert gb.linear_depth.data_ptr() == rt[..., 2].data_ptr()
    assert not native.KERNELS["gbuffer"].plain_cuda_calls


@pytest.mark.parametrize("path,counts", [("HYBRID", (13, 17)),
                                         ("FORWARD", (3, 3))])
def test_sharded_gbuffer_takes_one_exchange(path, counts):
    """On 4 CPU shards of 8 rows the G-buffer pass makes one exchange, a
    halo row of K1's depth and winners, and the frame as many exchanges
    as before the kernel (full graph: 13 on a first frame, 17 with a
    history; forward + TAA: 3); its image is the single-device frame's."""
    from hybridrenderer_tpu_torch.core.camera import OrbitCamera
    from hybridrenderer_tpu_torch.core.config import RenderSettings
    from hybridrenderer_tpu_torch.core.types import (RenderFlags,
                                                     RenderPathType)
    from hybridrenderer_tpu_torch.parallel.mesh import make_mesh
    from hybridrenderer_tpu_torch.parallel.sharded import ShardedRenderer
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer
    from hybridrenderer_tpu_torch.scene import scene as scenes

    flags = RenderFlags.default_hybrid() | RenderFlags.REFLECTION \
        | RenderFlags.GI if path == "HYBRID" \
        else RenderFlags.LIGHT | RenderFlags.IBL | RenderFlags.TAA
    s = RenderSettings(width=32, height=32, path=RenderPathType[path],
                       flags=flags, ao_block=8, gi_block=8)
    data = scenes.cube_scene().build("cpu")
    r = ShardedRenderer.for_scene(s, data, make_mesh(devices=["cpu"] * 4))
    single = Renderer.for_scene(s, data)
    cam = OrbitCamera(width=32, height=32, distance=7.0, pitch=0.45,
                      yaw=0.6, focal_point=(0, 0.7, 0))
    for _ in range(2):
        cs = cam.step(True)
        img = r.render(cs)
        torch.testing.assert_close(img, single.render(cs), rtol=0,
                                   atol=2e-4)
    for key, n in zip((("frame", False), ("frame", True)), counts):
        for plan in r.exchanges[key]:
            assert len(plan) == n
            kind, radius, images = plan[0]
            assert (kind, radius) == ("halo", 1)
            assert [dt for dt, _ in images] == [torch.float32, torch.int32]
