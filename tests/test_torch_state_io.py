"""History carried across packages: a state saved by the port resumes
in the reference, and one saved by the reference resumes in the port
(the same .npz layout; the reference writes bf16 planes as raw 2-byte
voids, the port widens them to float32). The cube's hybrid frame at
32x32: each package renders the next frame from the same history, held
to tests/test_torch_slice.py's cube SVGF gate (24 u8 off edges, p99 8:
the reference's own jit-vs-eager chaos, tests/torch_gate_reading.py,
plus margin)."""
import numpy as np
import pytest

from hybridrenderer_tpu.core.camera import OrbitCamera as RefCamera
from hybridrenderer_tpu.runtime import state_io as ref_state_io
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.runtime import state_io
from hybridrenderer_tpu_torch.runtime.output import to_u8
from hybridrenderer_tpu_torch.runtime.renderer import Renderer
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

from .test_torch_slice import (CASES, CUBE_CAM, _edge_tri_ids, _settings,
                               reference_renderer)
from .torch_parity import (clear_reference_knobs, flatten, off_edge_errors,
                           one_torch_thread)

SIZE = 32


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    clear_reference_knobs(monkeypatch)
    with one_torch_thread():
        yield


def test_history_resumes_across_packages(tmp_path):
    """The port renders two frames and saves; the reference resumes from
    that file and both render frame 3; the reference saves after it
    (bf16 planes as it writes them); the port resumes from that file and
    both render frame 4."""
    ref_data = ref_scenes.cube_scene().build()
    data = scene_from_numpy(flatten(ref_data), "cpu")
    gate = CASES["cube"][2:]
    port = Renderer.for_scene(_settings(SIZE), data)
    cam = OrbitCamera(width=SIZE, height=SIZE, **CUBE_CAM)
    ref_cam = RefCamera(width=SIZE, height=SIZE, **CUBE_CAM)
    for _ in range(2):
        port.render(cam.step())
        ref_cam.step()
    port_ck = str(tmp_path / "port.npz")
    state_io.save_renderer(port_ck, port)

    def next_frame_within_gate(direction, ref, port):
        ref_state = ref_cam.step()
        ref_img = to_u8(np.asarray(ref.render(ref_state)))
        img = to_u8(port.render_np(cam.step()))
        off_max, p99 = off_edge_errors(
            img, ref_img, _edge_tri_ids(ref_data, ref_state, SIZE))
        assert off_max <= gate[0] and p99 <= gate[1], (direction, off_max,
                                                      p99)

    # the port saves, the reference resumes: both render frame 3
    ref = reference_renderer(ref_data, SIZE)
    ref_state_io.restore_renderer(port_ck, ref)
    assert ref.frame_count == 2
    next_frame_within_gate("port → reference", ref, port)

    # the reference saves, a fresh port renderer resumes: frame 4
    ref_ck = str(tmp_path / "reference.npz")
    ref_state_io.save_renderer(ref_ck, ref)
    resumed = Renderer.for_scene(_settings(SIZE), data)
    state_io.restore_renderer(ref_ck, resumed)
    assert resumed.frame_count == 3
    assert str(resumed.state.history["SVGF_ShadowAO"].dtype) == \
        "torch.bfloat16"
    next_frame_within_gate("reference → port", ref, resumed)
