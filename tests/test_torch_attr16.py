"""Port vs reference: K1's bf16 attribute mode (raster_attr_bits=16).

The reference stores the raster kernel's 40 attribute planes as bf16
(raster_pallas.py:1107, a Pallas store of f32 into a bf16 output) and
upcasts them at the consumer (tests/test_raster_attrs.py:59-80). The
port's plain version is its f32 raster rounded to nearest bf16, and
``rasterize_binned`` returns the upcast; a frame with the setting renders
through it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridrenderer_tpu.core.camera import OrbitCamera as RefCamera
from hybridrenderer_tpu.ops import raster as ref_raster
from hybridrenderer_tpu.ops import raster_pallas
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType
from hybridrenderer_tpu_torch.ops import raster, raster_cuda
from hybridrenderer_tpu_torch.ops.image import tri_boundary_mask
from hybridrenderer_tpu_torch.runtime.renderer import Renderer
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

from .test_torch_raster import _port_cam
from .torch_parity import clear_reference_knobs, flatten, one_torch_thread

W, H = 64, 32
CAM = dict(distance=25.0, pitch=0.5, yaw=0.8, focal_point=(0, 2, 0))


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    clear_reference_knobs(monkeypatch)


def _clipped_port(data, cam):
    vp = cam.proj @ cam.view
    soup = data.triangles
    corners = torch.stack([raster.transform_to_clip(v, vp)
                           for v in (soup.v0, soup.v1, soup.v2)], dim=1)
    return raster.clip_triangles(corners, W, H)


def test_attr16_plain_matches_reference_kernel():
    """The plain version of K1's bf16 mode against the reference's
    ``rasterize_binned(..., interpret=True, attr_bits=16)`` on
    tests/test_raster_attrs.py's scene: tri ids equal off edges; the
    upcast attributes within one bf16 step of the reference's (at most
    2^-7 of the value, plus 1e-5: the two kernels' f32 values differ by
    ~1e-5 before rounding, which can move a value across a rounding
    boundary; 2 of 29,000 values do), and 99% of them bit for bit."""
    ref_data = ref_scenes.stress_scene(num_objects=8, seed=5).build()
    ref_cam = RefCamera(width=W, height=H, **CAM).step()
    clip = ref_raster.transform_to_clip(
        ref_data.vertices.world_position,
        jnp.asarray(ref_cam.proj) @ jnp.asarray(ref_cam.view))
    tris = ref_raster.clip_triangles(clip, ref_data.triangles.i0,
                                     ref_data.triangles.i1,
                                     ref_data.triangles.i2, W, H)
    ref_vis, ref_a16 = raster_pallas.rasterize_binned(
        tris, W, H, interpret=True, attr_table=ref_data.raster_rows,
        attr_bits=16)
    assert ref_a16.dtype == jnp.float32
    with one_torch_thread():
        data = scene_from_numpy(flatten(ref_data), "cpu")
        ptris = _clipped_port(data, _port_cam(ref_cam))
        vis16, a16 = raster_cuda.rasterize_binned(ptris, W, H,
                                                  data.raster_rows,
                                                  attr_bits=16)
        vis32, a32 = raster_cuda.rasterize_binned(ptris, W, H,
                                                  data.raster_rows)
    assert a16.dtype == torch.float32
    # the bf16 mode is the f32 raster rounded to nearest, nothing else
    assert torch.equal(a16, a32.to(torch.bfloat16).to(torch.float32))
    assert torch.equal(vis16.tri_id, vis32.tri_id)
    ref_tri = np.asarray(ref_vis.tri_id)
    off = ~tri_boundary_mask(ref_tri)
    np.testing.assert_array_equal(vis16.tri_id.numpy()[off], ref_tri[off])
    m = off & (ref_tri >= 0)
    assert m.mean() > 0.2
    a, b = a16.numpy()[m], np.asarray(ref_a16)[m]
    assert (np.abs(a - b) <= 2.0 ** -7 * np.abs(b) + 1e-5).all()
    assert (a == b).mean() > 0.99
    np.testing.assert_array_equal(a16.numpy()[ref_tri < 0], 0.0)


def test_attr16_frame_renders_near_f32():
    """A hybrid frame with raster_attr_bits=16 renders, finite, within
    bf16 rounding of the f32 frame (its G-buffer normals and albedo move
    by at most 2^-8 relative: 3 u8 of shading, p99 1)."""
    from hybridrenderer_tpu_torch.scene import scene as port_scenes

    size = 32
    s = RenderSettings(width=size, height=size, path=RenderPathType.HYBRID,
                       flags=RenderFlags.LIGHT | RenderFlags.IBL
                       | RenderFlags.SHADOW | RenderFlags.AO, ao_block=8)
    cam = OrbitCamera(width=size, height=size, distance=7.0, pitch=0.45,
                      yaw=0.6, focal_point=(0, 0.7, 0)).step()
    with one_torch_thread():
        data = port_scenes.cube_scene().build("cpu")
        f32 = Renderer.for_scene(s, data).render(cam).numpy()
        f16 = Renderer.for_scene(s.replace(raster_attr_bits=16),
                                 data).render(cam).numpy()
    assert np.isfinite(f16).all()
    u8 = lambda x: np.clip(x * 255.0 + 0.5, 0, 255).astype(int)
    diff = np.abs(u8(f16) - u8(f32))
    assert diff.max() <= 3 and np.percentile(diff, 99) <= 1
