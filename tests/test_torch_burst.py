"""render_burst against sequential frames and against the reference's
burst (its test_runtime's case: cornell, forward + TAA, 48x48, 3
frames): one call renders K frames (one CUDA graph on the card) with the
history carried exactly as through K render() calls."""
import numpy as np
import torch

from hybridrenderer_tpu.core.camera import OrbitCamera as RefCamera
from hybridrenderer_tpu.core.config import RenderSettings as RefSettings
from hybridrenderer_tpu.core.types import RenderFlags as RefFlags
from hybridrenderer_tpu.core.types import RenderPathType as RefPath
from hybridrenderer_tpu.ops import raster as ref_raster
from hybridrenderer_tpu.runtime.renderer import Renderer as RefRenderer
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType
from hybridrenderer_tpu_torch.runtime.output import to_u8
from hybridrenderer_tpu_torch.runtime.renderer import Renderer
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

from .torch_parity import (clear_reference_knobs, flatten, off_edge_errors,
                           one_torch_thread)

BURST_CAM = dict(distance=6.0, pitch=0.3, yaw=0.4, focal_point=(0, 1.0, 0))


def _burst_cams(n, cls):
    cam = cls(width=48, height=48, **BURST_CAM)
    out = []
    for _ in range(n):
        out.append(cam.step(taa_enabled=True))
        cam.orbit(0.02, 0.0)
    return out


def test_render_burst_equals_sequential_and_reference(monkeypatch):
    """render_burst of 3 forward + TAA frames (the reference's burst
    test) equals 3 render() calls bit for bit, history included, and the
    reference's render_burst at the reference gate (2 u8 off edges, p99
    1)."""
    clear_reference_knobs(monkeypatch)
    s = RenderSettings(width=48, height=48, path=RenderPathType.FORWARD,
                       flags=RenderFlags.LIGHT | RenderFlags.TAA)
    ref_data = ref_scenes.cornell_scene().build()
    data = scene_from_numpy(flatten(ref_data), "cpu")
    seq, bur = Renderer.for_scene(s, data), Renderer.for_scene(s, data)
    with one_torch_thread():
        frames_seq = [seq.render(c) for c in _burst_cams(3, OrbitCamera)]
        frames_bur = bur.render_burst(_burst_cams(3, OrbitCamera))
    assert frames_bur.shape == (3, 48, 48, 3) and bur.frame_count == 3
    for i in range(3):
        assert torch.equal(frames_bur[i], frames_seq[i]), i
    for k in seq.state.history:
        assert torch.equal(seq.state.history[k], bur.state.history[k]), k
    # a second burst continues the history
    with one_torch_thread():
        more_seq = [seq.render(c) for c in _burst_cams(2, OrbitCamera)]
        more_bur = bur.render_burst(_burst_cams(2, OrbitCamera))
    assert all(torch.equal(a, b) for a, b in zip(more_bur, more_seq))

    ref = RefRenderer.for_scene(RefSettings(
        width=48, height=48, path=RefPath.FORWARD,
        flags=RefFlags.LIGHT | RefFlags.TAA, raster_backend="jnp"), ref_data)
    ref_bur = np.asarray(ref.render_burst(_burst_cams(3, RefCamera)))
    cs = _burst_cams(3, RefCamera)[-1]
    soup = ref_data.triangles
    tri = np.asarray(ref_raster.rasterize_scene(
        ref_data.vertices.world_position, soup.i0, soup.i1, soup.i2, cs, 48,
        48, jitter_enabled=False).tri_id)
    off_max, p99 = off_edge_errors(to_u8(frames_bur[2].numpy()),
                                   to_u8(ref_bur[2]), tri)
    assert off_max <= 2 and p99 <= 1.0, (off_max, p99)
