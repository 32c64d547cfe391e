"""The fused dynamic frame against the reference's: DynamicScene's
commit_and_render (the transform update, the refit and the frame in one
call; one jitted dispatch in the reference, one CUDA graph on the card)
on the cube with entity 1 moving before each of 3 frames, 32x32, the
forward path with the sun's ray-traced shadow (LIGHT | SHADOW: the
refit tree is traced every frame, and no SVGF chaos), held to the
reference gate: 2 u8 off triangle edges, p99 1. The port's fused frame
equals its commit() + render() bit for bit
(tests/test_torch_dynamic.py)."""
import numpy as np

from hybridrenderer_tpu.core.camera import OrbitCamera as RefCamera
from hybridrenderer_tpu.core.config import RenderSettings as RefSettings
from hybridrenderer_tpu.core.types import RenderFlags as RefFlags
from hybridrenderer_tpu.core.types import RenderPathType as RefPath
from hybridrenderer_tpu.runtime.renderer import Renderer as RefRenderer
from hybridrenderer_tpu.scene import dynamic as ref_dynamic
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType
from hybridrenderer_tpu_torch.graph.passes import _clip_scene
from hybridrenderer_tpu_torch.ops import raster_cuda
from hybridrenderer_tpu_torch.runtime.output import to_u8
from hybridrenderer_tpu_torch.runtime.renderer import Renderer
from hybridrenderer_tpu_torch.scene import scene as port_scenes
from hybridrenderer_tpu_torch.scene.dynamic import DynamicScene

from .torch_parity import (clear_reference_knobs, off_edge_errors,
                           one_torch_thread)

SIZE = 32
CAM = dict(distance=7.0, pitch=0.45, yaw=0.6, focal_point=(0, 0.7, 0))


def _moves(dyn):
    for i in range(3):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = [0.3 * i, 0.75, 0.1 * i]
        dyn.set_entity_transform(1, m)
        yield i


def test_fused_dynamic_frame_matches_reference(monkeypatch):
    clear_reference_knobs(monkeypatch)
    ref_host = ref_scenes.cube_scene()
    ref = RefRenderer.for_scene(RefSettings(
        width=SIZE, height=SIZE, path=RefPath.FORWARD,
        flags=RefFlags.LIGHT | RefFlags.SHADOW, raster_backend="jnp",
        trace_backend="jnp"), ref_host.build())
    ref_dyn = ref_dynamic.DynamicScene(ref_host, ref)
    ref_cam = RefCamera(width=SIZE, height=SIZE, **CAM)
    for _ in _moves(ref_dyn):
        ref_img = to_u8(np.asarray(ref_dyn.commit_and_render(
            ref_cam.step())))

    settings = RenderSettings(width=SIZE, height=SIZE,
                              path=RenderPathType.FORWARD,
                              flags=RenderFlags.LIGHT | RenderFlags.SHADOW)
    with one_torch_thread():
        host = port_scenes.cube_scene()
        r = Renderer.for_scene(settings, host.build("cpu"))
        dyn = DynamicScene(host, r)
        cam = OrbitCamera(width=SIZE, height=SIZE, **CAM)
        for _ in _moves(dyn):
            cs = cam.step()
            img = to_u8(dyn.commit_and_render(cs).numpy())
        # triangle edges of the moved scene (the renderer's, updated in
        # place by the fused frames)
        _, (tris,) = _clip_scene(settings, r.scene, cs.to("cpu"), False)
        vis, _ = raster_cuda.rasterize_binned(tris, SIZE, SIZE, None)
    assert r.frame_count == 3 and ref_img.std() > 0
    off_max, p99 = off_edge_errors(img, ref_img, vis.tri_id.numpy())
    assert off_max <= 2 and p99 <= 1.0, (off_max, p99)
