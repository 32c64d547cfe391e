"""Port vs reference: the full graph — G-buffer → RT shadow + AO,
RT reflections and diffuse GI (closest-hit traversal, K2c, with hit
shading) → SVGF with three chains → composition → post-process — on the
CPU, where every kernel of the port runs as its plain PyTorch version.

Image gate: bench.py's golden rule, the u8 error off triangle edges
(tri_boundary_mask, dilate 1), plus the p99 of all errors. With SVGF on,
each gate stands 4 u8 / 2 above the reference's own disagreement between
its jitted and eager renders of the same frames, as the cube gate of
tests/test_torch_slice.py does (tests/torch_gate_reading.py prints the
readings): cube 17 / 4, cornell 50 / 28 at 64x64 over 3 frames, and
127 / 31 for the cornell_full_128 golden's case. SVGF's variance is the
cancellation m2 - m1^2, and with the reflection and GI chains
demodulated by albedo it steers the edge-stopping weights even more than
on the hybrid frame, so ulp-level differences grow; the port's renders
sit as far from the jitted reference as its eager renders do. Everything
before SVGF is held to 2 u8 / p99 1 in tests/test_torch_full_graph_raw.py.
"""
import os

import numpy as np
import pytest

from hybridrenderer_tpu.core.camera import OrbitCamera as RefCamera
from hybridrenderer_tpu.core.types import RenderFlags as RefFlags
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.types import RenderFlags
from hybridrenderer_tpu_torch.graph.params import RS
from hybridrenderer_tpu_torch.runtime.output import read_png, to_u8
from hybridrenderer_tpu_torch.runtime.renderer import Renderer
from hybridrenderer_tpu_torch.scene import scene as port_scenes
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

from .test_torch_slice import (CORNELL_CAM, CUBE_CAM, _edge_tri_ids,
                               _settings, reference_renderer)
from .torch_parity import clear_reference_knobs, flatten, off_edge_errors

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "cornell_full_128.png")
REF_FULL = RefFlags.default_hybrid() | RefFlags.REFLECTION | RefFlags.GI
FULL = RenderFlags.default_hybrid() | RenderFlags.REFLECTION | RenderFlags.GI
FULL_CASES = {
    # scene, camera, off-edge max, p99 (module docstring)
    "cornell": (ref_scenes.cornell_scene, CORNELL_CAM, 54, 30.0),
    "cube": (ref_scenes.cube_scene, CUBE_CAM, 21, 6.0),
}
GOLDEN_OFF_EDGE_MAX, GOLDEN_P99_MAX = 131, 33.0


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    clear_reference_knobs(monkeypatch)


def check_full_graph(case):
    """64x64, 3 frames, golden settings (ao_block 8, gi_block 8), the
    reference jitted on its CPU paths."""
    scene_fn, cam_kw, max_off, max_p99 = FULL_CASES[case]
    size, frames = 64, 3
    ref_data = scene_fn().build()
    ref = reference_renderer(ref_data, size, REF_FULL)
    port = Renderer.for_scene(_settings(size).replace(flags=FULL),
                              scene_from_numpy(flatten(ref_data), "cpu"))
    ref_cam = RefCamera(width=size, height=size, **cam_kw)
    cam = OrbitCamera(width=size, height=size, **cam_kw)
    for _ in range(frames):
        ref_state = ref_cam.step()
        ref_img = to_u8(np.asarray(ref.render(ref_state)))
        img = to_u8(port.render_np(cam.step()))
    off_max, p99 = off_edge_errors(
        img, ref_img, _edge_tri_ids(ref_data, ref_state, size))
    assert off_max <= max_off and p99 <= max_p99, (off_max, p99)
    # three SVGF chains carry history, each at the configured width
    assert {"SVGF_ShadowAO", "SVGF_Refl", "SVGF_GI"} <= set(port.state.history)
    assert port.state.history["SVGF_GI"].shape == (size, size, 4)
    assert RS.REFLECTION_RAW not in port.state.history


def test_full_graph_matches_reference():
    """The cornell case; the cube case runs in
    tests/test_torch_full_graph_raw.py, so each file stays short."""
    check_full_graph("cornell")


def test_port_matches_full_graph_golden():
    """tests/goldens/cornell_full_128.png, the reference's CPU render, by
    the port alone: 128x128, 2 frames, ao_block 8, gi_block 8."""
    size = 128
    r = Renderer.for_scene(_settings(size).replace(flags=FULL),
                           port_scenes.cornell_scene().build("cpu"))
    cam = OrbitCamera(width=size, height=size, **CORNELL_CAM)
    for _ in range(2):
        img = to_u8(r.render_np(cam.step()))
    tri = _edge_tri_ids(ref_scenes.cornell_scene().build(),
                        RefCamera(width=size, height=size,
                                  **CORNELL_CAM).step(), size)
    off_max, p99 = off_edge_errors(img, read_png(GOLDEN), tri)
    assert off_max <= GOLDEN_OFF_EDGE_MAX and p99 <= GOLDEN_P99_MAX, \
        (off_max, p99)
