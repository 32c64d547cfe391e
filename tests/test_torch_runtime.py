"""The port's runtime against the reference's, on the CPU: the packed
camera row and the frame parameters read from it, the padded tile
binning a captured frame uses, exposure and the SVGF phis read on the
device, checkpoint and resume, the tracer's spans, the log channels, and
the capture check of tests/torch_capture.py over the frame functions.
The burst, the fused dynamic frame and history across packages have
files of their own (test_torch_burst.py, test_torch_dynamic_fused.py,
test_torch_state_io.py)."""
import logging

import numpy as np
import pytest
import torch

from hybridrenderer_tpu.core.camera import CameraState as RefCameraState
from hybridrenderer_tpu.core.camera import OrbitCamera as RefCamera
from hybridrenderer_tpu.core.config import RenderSettings as RefSettings
from hybridrenderer_tpu.core.types import RenderFlags as RefFlags
from hybridrenderer_tpu.core.types import RenderPathType as RefPath
from hybridrenderer_tpu.graph.params import FrameParams as RefFrameParams
from hybridrenderer_tpu.runtime.renderer import Renderer as RefRenderer
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu_torch.core.camera import CameraState, OrbitCamera
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType
from hybridrenderer_tpu_torch.graph.params import (ROW_SIZE, FrameParams,
                                                   FrameState, pack_row)
from hybridrenderer_tpu_torch.graph.passes import _clip_scene
from hybridrenderer_tpu_torch.ops import raster_cuda
from hybridrenderer_tpu_torch.runtime import log, profiling, state_io
from hybridrenderer_tpu_torch.runtime.renderer import DEFAULT_PHI, Renderer
from hybridrenderer_tpu_torch.scene import scene as port_scenes
from hybridrenderer_tpu_torch.scene.dynamic import DynamicScene

from .torch_capture import CaptureLint
from .torch_parity import clear_reference_knobs, one_torch_thread

CUBE_CAM = dict(distance=7.0, pitch=0.45, yaw=0.6, focal_point=(0, 0.7, 0))


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    clear_reference_knobs(monkeypatch)
    with one_torch_thread():
        yield


def _hybrid(size, **kw):
    return RenderSettings(width=size, height=size, path=RenderPathType.HYBRID,
                          flags=RenderFlags.default_hybrid(), ao_block=8,
                          gi_block=8, **kw)


def _translate(x, y, z):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (x, y, z)
    return m


def test_camera_pack_unpack_equal_reference():
    """The packed camera row, bit for bit, and its unpacked fields."""
    for taa in (False, True):
        ref, cam = RefCamera(width=40, height=24, **CUBE_CAM), \
            OrbitCamera(width=40, height=24, **CUBE_CAM)
        for _ in range(3):
            r, p = ref.step(taa), cam.step(taa)
            ref.orbit(0.1, 0.02)
            cam.orbit(0.1, 0.02)
        packed = p.pack()
        assert packed.shape == (CameraState.PACKED_SIZE,) == \
            (RefCameraState.PACKED_SIZE,)
        np.testing.assert_array_equal(packed, r.pack())
        ref_un = RefCameraState.unpack(r.pack())
        un = CameraState.unpack(torch.from_numpy(packed))
        for f in ("view", "proj", "view_inverse", "proj_inverse",
                  "view_proj_inverse", "prev_view", "prev_proj", "position",
                  "jitter", "prev_jitter"):
            np.testing.assert_array_equal(getattr(un, f).numpy(),
                                          np.asarray(getattr(ref_un, f)), f)


def test_frame_params_from_row_equal_create():
    """FrameParams read from the frame's row equal FrameParams.create's
    host numbers, and the reference's."""
    data = port_scenes.cube_scene().build("cpu")
    cs = OrbitCamera(width=32, height=32, **CUBE_CAM).step(True)
    phi = (3.0, 100.0, 0.05, 0.0)
    row = pack_row(cs, 0.7, phi, 41)
    assert row.shape == (ROW_SIZE,) and row.dtype == np.float32
    got = FrameParams.from_row(data, torch.from_numpy(row))
    want = FrameParams.create(data, exposure=0.7, frame_index=41,
                              svgf_phi=phi)
    ref = RefFrameParams.create(ref_scenes.cube_scene().build(),
                                exposure=0.7, frame_index=41, svgf_phi=phi)
    assert float(got.exposure) == want.exposure == float(ref.exposure)
    assert [float(x) for x in got.svgf_phi] == list(want.svgf_phi)
    np.testing.assert_array_equal(got.svgf_phi.numpy(), ref.svgf_phi)
    assert got.frame_index.dtype == torch.int64
    assert int(got.frame_index) == want.frame_index == int(ref.frame_index)
    for f in ("sun_direction", "sun_color", "sun_intensity",
              "ambient_strength"):
        assert getattr(got, f) is getattr(want, f)


@pytest.fixture(scope="module")
def cornell_candidates():
    data = port_scenes.cornell_scene().build("cpu")
    w, h = 203, 117
    cam = OrbitCamera(width=w, height=h, distance=9.0, pitch=0.2,
                      focal_point=(0, 2.5, 0)).step().to("cpu")
    _, (tris,) = _clip_scene(RenderSettings(width=w, height=h), data, cam,
                             False)
    _, bbox, valid = raster_cuda.pack_candidates(tris)
    return bbox, valid, w, h


@pytest.mark.parametrize("extra", [0, 5000, -7])
def test_padded_binning_equals_exact(cornell_candidates, extra):
    """The padded lists of a captured frame (capacity = the exact entry
    count + ``extra``) against the exact lists: the same tile_start and
    entry prefix, zeros after it, and the entries needed; under capacity
    (extra < 0) needed exceeds it, which the renderer raises on."""
    bbox, valid, w, h = cornell_candidates
    ts, ec = raster_cuda.bin_candidates(bbox, valid, w, h)
    n = ec.shape[0]
    binning = raster_cuda.Binning(n + extra)
    ts_p, ec_p = binning.bin(bbox, valid, w, h)
    needed = binning.max_needed(bbox.device)
    assert int(needed) == n and ec_p.shape == (n + extra,)
    if extra >= 0:
        assert torch.equal(ts_p, ts)
        assert torch.equal(ec_p[:n], ec) and not ec_p[n:].any()
    else:
        assert int(needed) > ec_p.shape[0]
        assert int(ts_p[-1]) == n + extra


def test_row_params_equal_host_params():
    """Exposure and the SVGF phis changed between frames: the renderer's
    frames (parameters read from the row on the device) equal the path
    run with FrameParams.create's host numbers, bit for bit."""
    size = 32
    settings = _hybrid(size)
    r = Renderer.for_scene(settings, port_scenes.cube_scene().build("cpu"))
    cam, cam_b = (OrbitCamera(width=size, height=size, **CUBE_CAM)
                  for _ in range(2))
    state = FrameState.empty()
    for i, (exposure, phi) in enumerate([
            (1.0, DEFAULT_PHI), (0.6, (2.0, 64.0, 0.1, 0.0)),
            (1.4, (6.0, 200.0, 0.01, 0.0))]):
        img = r.render(cam.step(), exposure=exposure, svgf_phi=phi)
        cs = cam_b.step()
        ctx, _ = r._context(torch.from_numpy(
            pack_row(cs, exposure, phi, i)), r.scene, r.tracer,
            state.history, i > 0)
        ctx.cam = cs.to("cpu")
        ctx.params = FrameParams.create(r.scene, exposure=exposure,
                                        frame_index=i, svgf_phi=phi)
        want, state, _ = r.path.run(ctx, state)
        assert torch.equal(img, want), i


def test_state_io_round_trip_bitexact(tmp_path):
    """Two hybrid frames, a checkpoint, a fresh renderer resumed from it
    and two more frames: bit for bit the straight four-frame run (the
    reference's test_state_io), bf16 SVGF history included."""
    data = port_scenes.cube_scene().build("cpu")

    def run(n, resume_from=None):
        r = Renderer.for_scene(_hybrid(32), data)
        cam = OrbitCamera(width=32, height=32, **CUBE_CAM)
        if resume_from:
            state_io.restore_renderer(resume_from, r)
            for _ in range(r.frame_count):
                cam.step()
        return r, [r.render(cam.step()) for _ in range(n)]

    _, straight = run(4)
    r, _ = run(2)
    assert r.state.history["SVGF_ShadowAO"].dtype == torch.bfloat16
    ck = str(tmp_path / "state.npz")
    state_io.save_renderer(ck, r)
    state, frames = state_io.load_state(ck)
    assert frames == 2 and state.history.keys() == r.state.history.keys()
    for k, v in r.state.history.items():
        assert torch.equal(state.history[k].to(v.dtype), v), k
    _, resumed = run(2, resume_from=ck)
    assert torch.equal(resumed[0], straight[2])
    assert torch.equal(resumed[1], straight[3])


def test_traced_frame_spans_equal_reference_pass_names():
    """A renderer made with ``trace=True`` times every pass of the path,
    under the reference's pass names and in its order, then the frame
    body and the commit (host clock on the CPU), and renders the frames
    an untraced renderer renders; reset_trace clears the sums."""
    data = port_scenes.cube_scene().build("cpu")
    r = Renderer.for_scene(_hybrid(32), data, trace=True)
    plain = Renderer.for_scene(_hybrid(32), data)
    cam = OrbitCamera(width=32, height=32, **CUBE_CAM)
    for _ in range(2):
        cs = cam.step()
        assert torch.equal(r.render(cs), plain.render(cs))
    ref = RefRenderer(RefSettings(width=32, height=32, path=RefPath.HYBRID,
                                  flags=RefFlags.default_hybrid()),
                      ref_scenes.cube_scene().build())
    passes = [p.name for p in ref.path.graph.passes]
    tot = r.trace_totals()
    assert tot["clock"] == "host"
    assert list(tot["device"]) == passes + ["frame", "commit"]
    assert all(n == 2 and ms >= 0.0 for ms, n in tot["device"].values())
    assert sum(tot["device"][p][0] for p in passes) <= \
        tot["device"]["frame"][0]
    assert {k: n for k, (_, n) in tot["host"].items()} == {"upload": 2}
    assert tot["recaptures"] == 0
    r.reset_trace()
    assert r.trace_totals()["device"] == {}


def test_host_spans_on_the_profiler_timeline():
    """Under torch.profiler a traced renderer's host spans are events
    named hr.<span> on its timeline."""
    from torch.profiler import ProfilerActivity, profile

    r = Renderer.for_scene(_hybrid(32), port_scenes.cube_scene().build(
        "cpu"), trace=True)
    cam = OrbitCamera(width=32, height=32, **CUBE_CAM)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render(cam.step())
    assert "hr.upload" in {e.name for e in prof.events()}


def test_untraced_renderer_opens_no_span(monkeypatch):
    """Without ``trace`` a renderer holds profiling.OFF: two frames and a
    dynamic frame open no span, create no record_function, collect no
    event for a graph, and trace_totals holds the recapture count
    alone."""
    def opened(*a, **k):
        raise AssertionError("a span was opened")

    for name in ("host", "device", "collecting", "flush", "replayed"):
        monkeypatch.setattr(profiling.Tracer, name, opened)
    monkeypatch.setattr(profiling, "record_function", opened)
    host = port_scenes.cube_scene()
    r = Renderer.for_scene(_hybrid(32), host.build("cpu"))
    assert r.tracing is profiling.OFF and r.tracing.run_pass is None
    assert r.tracing.host("upload") is profiling.NULL
    with r.tracing.collecting() as spans:
        assert spans == ()
    dyn = DynamicScene(host, r)
    cam = OrbitCamera(width=32, height=32, **CUBE_CAM)
    r.render(cam.step())
    dyn.set_entity_transform(1, _translate(0.3, 0.75, 0.0))
    dyn.commit_and_render(cam.step())
    assert r.trace_totals() == {"recaptures": 0}


def test_traced_dynamic_update_spans():
    """A traced dynamic frame (DynamicScene.commit_and_render) times the
    scene update and the refit before the passes, the frame and the
    commit, and its host spans time dynamic_pending and the upload;
    DynamicScene.commit alone times the update, refit and commit,
    with no frame."""
    host = port_scenes.cube_scene()
    r = Renderer.for_scene(_hybrid(32), host.build("cpu"), trace=True)
    dyn = DynamicScene(host, r)
    cam = OrbitCamera(width=32, height=32, **CUBE_CAM)
    dyn.set_entity_transform(1, _translate(0.3, 0.75, 0.0))
    dyn.commit_and_render(cam.step())
    passes = [p.name for p in r.path.graph.passes]
    tot = r.trace_totals()
    assert list(tot["device"]) == ["scene.update", "scene.refit"] + \
        passes + ["frame", "commit"]
    assert {k: n for k, (_, n) in tot["host"].items()} == {
        "dynamic_pending": 1, "upload": 1}
    r.reset_trace()
    dyn.set_entity_transform(1, _translate(0.6, 0.75, 0.0))
    dyn.commit()
    assert list(r.trace_totals()["device"]) == ["scene.update",
                                                "scene.refit", "commit"]


def test_structured_log_channels():
    """The log channels (the reference's test_runtime): named channel,
    level, structured fields and the caller's file:line."""
    ch = log.core().bind(scene="cube")
    rec = {}

    class Capture(logging.Handler):
        def emit(self, record):
            rec["line"] = self.format(record)

    lg = logging.getLogger("CHIMERA")
    cap = Capture()
    cap.setFormatter(lg.handlers[0].formatter)
    lg.addHandler(cap)
    try:
        ch.info("scene built", tris=12)
        assert "CHIMERA info" in rec["line"]
        assert "scene=cube" in rec["line"] and "tris=12" in rec["line"]
        assert "test_torch_runtime.py" in rec["line"]
        ch.trace("suppressed at info")
        assert "suppressed" not in rec["line"]
        log.client().info("app line")
    finally:
        lg.removeHandler(cap)


def _lint_frames(r, dyn=None, frames=2):
    """Render ``frames`` frames eagerly (a key's first use), then run the
    frame functions of both history keys under CaptureLint with a padded
    binning → the operations a capture would refuse."""
    cam = OrbitCamera(width=32, height=32, **CUBE_CAM)

    def pending(i):
        dyn.set_entity_transform(1, _translate(0.1 * i, 0.75, 0.0))
        args = dyn._pending()
        dyn._dirty_entities.clear()
        return args

    for i in range(frames):
        if dyn is None:
            r.render(cam.step(True))
        else:
            r.render_dynamic(cam.step(True), dyn.maps, *pending(i))
    lint = CaptureLint()
    row = torch.from_numpy(pack_row(cam.step(True), 1.0, DEFAULT_PHI, 9))
    for hv in (False, True):
        if dyn is not None:
            tf, vi, ti, subset, lights = pending(frames)
            tf = r._upload_transforms(tf)
        with lint, torch.no_grad():
            scene, tracer = r.scene, r.tracer
            if dyn is not None:
                scene, tracer = r._updated(dyn.maps, tf, vi, ti, subset,
                                           lights)
            r._frame(row, scene, tracer, r._history_for(hv), hv,
                     raster_cuda.Binning(1 << 16))
    return lint.found


@pytest.mark.parametrize("case", ["dynamic_mimt", "raytraced_packet"])
def test_frame_functions_capturable(case):
    """After a key's first (eager) frame, its frame function makes no host
    sync and copies no host data outside the kernels' plain versions: a
    dynamic hybrid frame through the refit 8-wide tree (K2m), and the
    ray-traced path with K1v and K2b."""
    if case == "dynamic_mimt":
        host = port_scenes.cube_scene()
        r = Renderer.for_scene(_hybrid(32, trace_backend="pallas-wide",
                                       wide_kernel="mimt"), host.build("cpu"))
        found = _lint_frames(r, DynamicScene(host, r))
    else:
        s = RenderSettings(width=32, height=32,
                           path=RenderPathType.RAYTRACED,
                           flags=RenderFlags.LIGHT | RenderFlags.IBL
                           | RenderFlags.EMISSIVE | RenderFlags.TAA,
                           raster_eval="v2", trace_backend="pallas")
        found = _lint_frames(Renderer.for_scene(
            s, port_scenes.cube_scene().build("cpu")))
    assert not found, sorted(set(found))
