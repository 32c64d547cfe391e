"""Port vs reference: whole hybrid frames of a textured scene (the stress
scene with its four procedural colour textures) and of the cut-out scene
(alpha-tested leaves: the two-layer G-buffer and the alpha rounds of the
shadow and AO rays), on the CPU, where every kernel of the port runs as
its plain PyTorch version.

With SVGF off a frame carries no SVGF chaos and is held to 2 u8 off
triangle edges, p99 1, against the reference on its CPU paths (raster,
trace and SVGF backends "jnp"; tests/test_torch_slice.py). The textured
frame's camera stands back until no triangle is near-plane clipped: a
clipped triangle's barycentrics are ill-conditioned, and on the stress
scene's floor the reference's own jitted and eager renders then differ
by up to 26 u8 through its checker texture (the port agrees with the
eager render there to 1 u8). With SVGF on,
the port alone is held to the reference's goldens
(tests/goldens/stress_textured_128.png, cutout_hybrid_128.png) at the
reference's own disagreement between its jitted and eager renders of the
same frames plus 4 u8 / 2, as the cube golden is:
``python -m tests.torch_gate_reading stress_textured_128
cutout_hybrid_128`` prints that reading.
"""
import os

import numpy as np
import pytest

from hybridrenderer_tpu.core.camera import OrbitCamera as RefCamera
from hybridrenderer_tpu.core.types import RenderFlags as RefFlags
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.types import RenderFlags
from hybridrenderer_tpu_torch.runtime.output import read_png, to_u8
from hybridrenderer_tpu_torch.runtime.renderer import Renderer
from hybridrenderer_tpu_torch.scene import scene as port_scenes
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

from .test_torch_slice import _edge_tri_ids, _settings, reference_renderer
from .torch_parity import (clear_reference_knobs, flatten, off_edge_errors,
                          one_torch_thread)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
STRESS_CAM = dict(distance=18.0, pitch=0.5, yaw=0.8, focal_point=(0, 2.0, 0))
CUTOUT_CAM = dict(distance=9.0, pitch=0.35, yaw=0.4, focal_point=(0, 1.2, 0))
# the goldens' scenes and cameras (tests/test_golden_ladder.py), hybrid
# flags, 128x128, 2 frames, ao_block 8; the gate: off-edge max, p99, the
# reference's jit-vs-eager reading plus 4 / 2 (readings: 79 / 17 on
# stress_textured_128, where the textures' sharp edges feed SVGF's
# variance; 24 / 6 on cutout_hybrid_128)
GOLDENS = {
    "stress_textured_128": (
        lambda: ref_scenes.stress_scene(num_objects=24, textured=True),
        lambda: port_scenes.stress_scene(num_objects=24, textured=True),
        STRESS_CAM, 83, 19.0),
    "cutout_hybrid_128": (ref_scenes.cutout_scene, port_scenes.cutout_scene,
                          CUTOUT_CAM, 28, 8.0),
}
# the SVGF-off frames' cameras: the stress scene's from 50 away, where
# nothing is clipped (the nearest vertex at w 13.7)
FRAME_CAMS = {"stress_textured_128": dict(STRESS_CAM, distance=50.0),
              "cutout_hybrid_128": CUTOUT_CAM}
SVGF_OFF = RenderFlags.default_hybrid() & ~(
    RenderFlags.SVGF | RenderFlags.SVGF_TEMPORAL | RenderFlags.SVGF_SPATIAL)
REF_SVGF_OFF = RefFlags.default_hybrid() & ~(
    RefFlags.SVGF | RefFlags.SVGF_TEMPORAL | RefFlags.SVGF_SPATIAL)


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    clear_reference_knobs(monkeypatch)
    with one_torch_thread():
        yield


@pytest.mark.parametrize("case", sorted(GOLDENS))
def test_frame_without_svgf_matches_reference(case):
    """SVGF off, two 64x64 frames: the textured G-buffer (or the cut-out
    layers' merge), shading and the raw shadow and AO signals (their
    alpha rounds in the cut-out scene), to 2 u8 / p99 1."""
    ref_fn = GOLDENS[case][0]
    cam_kw = FRAME_CAMS[case]
    size = 64
    ref_data = ref_fn().build()
    ref = reference_renderer(ref_data, size, REF_SVGF_OFF)
    port = Renderer.for_scene(_settings(size).replace(flags=SVGF_OFF),
                              scene_from_numpy(flatten(ref_data), "cpu"))
    ref_cam = RefCamera(width=size, height=size, **cam_kw)
    cam = OrbitCamera(width=size, height=size, **cam_kw)
    for _ in range(2):
        ref_state = ref_cam.step()
        ref_img = to_u8(np.asarray(ref.render(ref_state)))
        img = to_u8(port.render_np(cam.step()))
    assert ref_img.std() > 0.0
    off_max, p99 = off_edge_errors(
        img, ref_img, _edge_tri_ids(ref_data, ref_state, size))
    assert off_max <= 2 and p99 <= 1.0, (off_max, p99)


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_port_matches_golden(name):
    """The reference's golden, by the port alone, built from the port's
    own canned scene (SVGF on)."""
    ref_fn, port_fn, cam_kw, max_off, max_p99 = GOLDENS[name]
    size = 128
    r = Renderer.for_scene(_settings(size), port_fn().build("cpu"))
    cam = OrbitCamera(width=size, height=size, **cam_kw)
    for _ in range(2):
        img = to_u8(r.render_np(cam.step()))
    tri = _edge_tri_ids(ref_fn().build(),
                        RefCamera(width=size, height=size, **cam_kw).step(),
                        size)
    off_max, p99 = off_edge_errors(
        img, read_png(os.path.join(GOLDEN_DIR, name + ".png")), tri)
    assert off_max <= max_off and p99 <= max_p99, (off_max, p99)
