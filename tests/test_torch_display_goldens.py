"""The reference's display-mode goldens (tests/test_golden_ladder.py:
cube_display_normal_128, cube_display_depth_128 and
cube_display_shadow_128; hybrid flags, ao_block = gi_block = 8) rendered
by the port on the CPU, held off triangle edges. NORMAL and DEPTH show
the G-buffer and take bench.py's golden gate, 16 u8 / p99 2. SHADOW
shows the shadow and AO signal after two frames of SVGF, where the
reference disagrees with itself: its eager render is 30 u8 / p99 6 off
its jitted render of the same frames, and the port is 31 / 6 off each
(``python -m tests.torch_gate_reading cube_display_shadow_128``), as on
the cube's final image (20 / 6, gate 24 / 8). So no render of either
package comes closer to the golden than that; it takes the reading
plus 4 / 2, as the cube does. What that gate cannot see, the signal
before SVGF, is held to the reference at 2 / 1 on the golden's scene,
camera and frames with SVGF off (SVGF itself is held stage by stage in
tests/test_torch_svgf.py)."""
import os

import numpy as np
import pytest

from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.core.types import (DisplayMode, RenderFlags,
                                                 RenderPathType)
from hybridrenderer_tpu_torch.graph.passes import _clip_scene
from hybridrenderer_tpu_torch.ops import raster_cuda
from hybridrenderer_tpu_torch.ops.image import tri_boundary_mask
from hybridrenderer_tpu_torch.runtime.output import read_png, to_u8
from hybridrenderer_tpu_torch.runtime.renderer import Renderer
from hybridrenderer_tpu_torch.scene import scene as scenes

from .test_torch_slice import (SVGF_FLAGS, _edge_tri_ids,
                               reference_renderer)
from .torch_parity import (clear_reference_knobs, flatten, off_edge_errors,
                           one_torch_thread)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
CUBE_CAM = dict(distance=7.0, pitch=0.45, yaw=0.6, focal_point=(0, 0.7, 0))
# golden: (display mode, frames as the reference's ladder renders them,
# off-edge max, p99)
DISPLAY = {
    "cube_display_normal_128": (DisplayMode.NORMAL, 1, 16, 2.0),
    "cube_display_depth_128": (DisplayMode.DEPTH, 1, 16, 2.0),
    "cube_display_shadow_128": (DisplayMode.SHADOW, 2, 34, 8.0),
}


@pytest.mark.parametrize("name", sorted(DISPLAY))
def test_display_golden(name):
    mode, frames, gate_off, gate_p99 = DISPLAY[name]
    size = 128
    settings = RenderSettings(width=size, height=size,
                              path=RenderPathType.HYBRID,
                              flags=RenderFlags.default_hybrid(),
                              display_mode=mode, ao_block=8, gi_block=8)
    with one_torch_thread():
        data = scenes.cube_scene().build("cpu")
        r = Renderer.for_scene(settings, data)
        cam = OrbitCamera(width=size, height=size, **CUBE_CAM)
        for _ in range(frames):
            img = to_u8(r.render_np(cam.step()))
        edge_cam = OrbitCamera(width=size, height=size, **CUBE_CAM).step()
        _, (tris,) = _clip_scene(settings, data, edge_cam.to("cpu"), False)
        vis, _ = raster_cuda.rasterize_binned(tris, size, size, None)
    golden = read_png(os.path.join(GOLDENS, name + ".png"))
    off_max, p99 = off_edge_errors(img, golden, vis.tri_id.numpy())
    assert img.std() > 0 and off_max <= gate_off and p99 <= gate_p99, \
        (off_max, p99)


def test_display_shadow_signal_matches_reference(monkeypatch):
    """The SHADOW display of the golden's scene, camera and two frames
    with SVGF off (the raw 1-spp shadow and AO signal) against the
    reference's render of the same scene arrays: off edges, at most 4 of
    the 16,384 pixels more than 2 u8 apart, and p99 1. The signal is one
    ray's hit or miss a pixel, so an ulp can flip a pixel from black to
    white; the reading is 1 pixel (0 / 255), every other pixel equal."""
    from hybridrenderer_tpu.core.camera import OrbitCamera as RefCamera
    from hybridrenderer_tpu.core.types import RenderFlags as RefFlags
    from hybridrenderer_tpu.scene import scene as ref_scenes
    from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

    clear_reference_knobs(monkeypatch)
    size = 128
    ref_data = ref_scenes.cube_scene().build()
    ref = reference_renderer(ref_data, size,
                             RefFlags.default_hybrid() & ~SVGF_FLAGS,
                             int(DisplayMode.SHADOW))
    ref_cam = RefCamera(width=size, height=size, **CUBE_CAM)
    settings = RenderSettings(
        width=size, height=size, path=RenderPathType.HYBRID,
        flags=RenderFlags.default_hybrid() & ~(
            RenderFlags.SVGF | RenderFlags.SVGF_TEMPORAL
            | RenderFlags.SVGF_SPATIAL),
        display_mode=DisplayMode.SHADOW, ao_block=8, gi_block=8)
    with one_torch_thread():
        r = Renderer.for_scene(settings,
                               scene_from_numpy(flatten(ref_data), "cpu"))
        cam = OrbitCamera(width=size, height=size, **CUBE_CAM)
        for _ in range(2):
            ref_state = ref_cam.step()
            ref_img = to_u8(np.asarray(ref.render(ref_state)))
            img = to_u8(r.render_np(cam.step()))
    assert ref_img.std() > 0
    edges = tri_boundary_mask(_edge_tri_ids(ref_data, ref_state, size),
                              dilate=1)
    diff = np.abs(img.astype(int) - ref_img.astype(int))
    flips = int((diff.max(-1)[~edges] > 2).sum())
    p99 = float(np.percentile(diff, 99))
    assert flips <= 4 and p99 <= 1.0, (flips, p99)
