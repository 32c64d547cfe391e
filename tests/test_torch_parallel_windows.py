"""The port's row-sharded frame (hybridrenderer_tpu_torch/parallel/) on
the CPU: 15-row shards, which align with neither K1's 16-row tiles nor
the 32x32 ray tiles, against the port's single-device frame (2e-4, the
reference's tolerance with ray passes; reading 0), and one sharded frame
against the reference's single-device frame at
tests/test_torch_forward.py's gate."""
import numpy as np
import pytest

from hybridrenderer_tpu.core.camera import OrbitCamera as RefCamera
from hybridrenderer_tpu.core.config import RenderSettings as RefSettings
from hybridrenderer_tpu.core.types import RenderFlags as RefFlags
from hybridrenderer_tpu.core.types import RenderPathType as RefPath
from hybridrenderer_tpu.runtime.renderer import Renderer as RefRenderer
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType
from hybridrenderer_tpu_torch.parallel.mesh import make_mesh
from hybridrenderer_tpu_torch.parallel.sharded import ShardedRenderer
from hybridrenderer_tpu_torch.runtime.output import to_u8
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

# _no_knobs (autouse) and cube are the fixtures of that file
from .test_torch_parallel import (FLAGS, FULL, RT, _no_knobs,  # noqa: F401
                                  _pair, cube)
from .test_torch_slice import CUBE_CAM, _edge_tri_ids
from .torch_parity import flatten, off_edge_errors


@pytest.mark.parametrize("path,flags,extra", [
    (RenderPathType.HYBRID, RenderFlags.default_hybrid(), {}),
    (RenderPathType.RAYTRACED, RT, {}),
    # half-res reflection and GI (odd first rows take the image's even
    # rows), per-pixel AO and GI draws, TEA-hash AO
    (RenderPathType.HYBRID, RenderFlags.default_hybrid() | FULL,
     dict(reflection_half_res=True, gi_half_res=True, ao_interleaved=False,
          gi_interleaved=False)),
    (RenderPathType.HYBRID, RenderFlags.default_hybrid(),
     dict(ao_interleaved=False, use_blue_noise=False)),
], ids=["hybrid", "raytraced", "half_res", "tea_ao"])
def test_15_row_shards(cube, path, flags, extra):
    """64x60 on 4 shards: 15-row windows cut K1's 16-row bands and the
    32x32 ray tiles; 2 frames each."""
    s = RenderSettings(width=64, height=60, path=path, flags=flags, **extra)
    single, sharded = _pair(s, cube, n=4, frames=2)
    for a, b in zip(single, sharded):
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-4)


def test_sharded_matches_reference():
    """One sharded forward frame against the reference's single-device
    frame (jitted, its CPU paths) at tests/test_torch_forward.py's gate:
    2 u8 off triangle edges, p99 1. tests/test_parallel.py ties the
    reference's own sharded frame to that frame."""
    size = 64
    ref_data = ref_scenes.cube_scene().build()
    ref = RefRenderer.for_scene(
        RefSettings(width=size, height=size, path=RefPath.FORWARD,
                    flags=RefFlags(int(FLAGS)), raster_backend="jnp"),
        ref_data)
    ref_state = RefCamera(width=size, height=size, **CUBE_CAM).step()
    ref_img = to_u8(np.asarray(ref.render(ref_state)))
    port = ShardedRenderer.for_scene(
        RenderSettings(width=size, height=size, path=RenderPathType.FORWARD,
                       flags=FLAGS),
        scene_from_numpy(flatten(ref_data), "cpu"),
        make_mesh(devices=["cpu"] * 8))
    img = to_u8(port.render_np(OrbitCamera(width=size, height=size,
                                           **CUBE_CAM).step()))
    off_max, p99 = off_edge_errors(img, ref_img,
                                   _edge_tri_ids(ref_data, ref_state, size))
    assert off_max <= 2 and p99 <= 1.0, (off_max, p99)
