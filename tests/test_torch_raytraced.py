"""Port vs reference: the ray-traced path (DepthPrepass → RaytracePass →
TAAPass → PostProcessPass), its raster kernels K1 (vis-only) and K1v
(raster_eval "v2" / "v3"), the runtime entry points that reach it
(switch_path, apply_settings, render_burst, benchmark), the triangle-id
limit of the raster records, and the two demo passes no path runs
(RTAOPass, RayQueryPass).

K1v's and K1's plain versions are held to the reference's Pallas raster
in interpret mode (eval modes v2 / v3 and v1), the path to the jitted
reference on CPU (raster_backend and trace_backend "jnp"), and the
port's CPU frame to the golden cube_raytraced_128.png."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridrenderer_tpu.core.camera import OrbitCamera as RefCamera
from hybridrenderer_tpu.core.config import RenderSettings as RefSettings
from hybridrenderer_tpu.core.types import RenderFlags as RefFlags
from hybridrenderer_tpu.core.types import RenderPathType as RefPath
from hybridrenderer_tpu.graph import rt_passes as ref_rt_passes
from hybridrenderer_tpu.ops import raster as ref_raster
from hybridrenderer_tpu.ops import raster_pallas
from hybridrenderer_tpu.runtime.renderer import Renderer as RefRenderer
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType
from hybridrenderer_tpu_torch.graph import rt_passes
from hybridrenderer_tpu_torch.graph.params import RS, FrameParams
from hybridrenderer_tpu_torch.graph.passes import FrameContext
from hybridrenderer_tpu_torch.ops import raster, raster_cuda, trace
from hybridrenderer_tpu_torch.ops.gbuffer import GBuffer
from hybridrenderer_tpu_torch.runtime.output import read_png, to_u8
from hybridrenderer_tpu_torch.runtime.renderer import Renderer
from hybridrenderer_tpu_torch.scene import scene as port_scenes
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

from .test_demo_passes import _setup as demo_setup
from .test_torch_raster import _port_cam
from .test_torch_slice import CUBE_CAM, _edge_tri_ids
from .torch_parity import (clear_reference_knobs, flatten, off_edge_errors,
                           one_torch_thread)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "cube_raytraced_128.png")
FLAGS = RenderFlags.LIGHT | RenderFlags.IBL | RenderFlags.EMISSIVE \
    | RenderFlags.TAA
PACKET = dict(raster_eval="v2", trace_backend="pallas")
# Outside the cube scene's 20 x 20 floor, so that no triangle crosses the
# near plane. At CUBE_CAM the floor is clipped, and its depth (ill-
# conditioned there, ROADMAP queue 3) differs from the reference jnp
# raster's by ~4e-6; the floor's rows have equal depths, so TAA's 3x3
# closest-depth dilation then picks another neighbour's motion, and
# frames 2-3 read 3 / 1 u8 off edges against the reference.
RT_CAM = dict(distance=14.0, pitch=0.25, yaw=0.0, focal_point=(0, 0.7, 0))


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    clear_reference_knobs(monkeypatch)
    with one_torch_thread():
        yield


def _settings(size, **kw):
    return RenderSettings(width=size, height=size,
                          path=RenderPathType.RAYTRACED, flags=FLAGS, **kw)


def _recording_registry(renderer):
    """Keep the last frame's registry in the returned list."""
    regs, run = [], renderer.path.run

    def recording(ctx, state):
        out = run(ctx, state)
        regs[:] = [out[2]]
        return out

    renderer.path.run = recording
    return regs


def test_raytraced_path_matches_reference():
    """3 frames with TAA at 64x64 on the cube against the jitted
    reference, each to 2 u8 / p99 1 off edges (reading: 0 / 0, 1 / 0,
    1 / 0). The reference's miss test is matched: a sky pixel's
    distance is -1 and it counts as a hit (rt_passes.py:250), so its
    linear depth in Motion is -1."""
    size = 64
    ref_data = ref_scenes.cube_scene().build()
    ref = RefRenderer.for_scene(
        RefSettings(width=size, height=size, path=RefPath.RAYTRACED,
                    flags=RefFlags(int(FLAGS)), raster_backend="jnp",
                    trace_backend="jnp"), ref_data)
    port = Renderer.for_scene(_settings(size),
                              scene_from_numpy(flatten(ref_data), "cpu"))
    regs = _recording_registry(port)
    ref_cam = RefCamera(width=size, height=size, **RT_CAM)
    cam = OrbitCamera(width=size, height=size, **RT_CAM)
    for frame in range(3):
        ref_state = ref_cam.step(taa_enabled=True)
        ref_img = to_u8(np.asarray(ref.render(ref_state)))
        img = to_u8(port.render_np(cam.step(taa_enabled=True)))
        ref_cam.orbit(0.02, 0.0)
        cam.orbit(0.02, 0.0)
        tri = _edge_tri_ids(ref_data, ref_state, size)
        off_max, p99 = off_edge_errors(img, ref_img, tri)
        assert off_max <= 2 and p99 <= 1.0, (frame, off_max, p99)
    sky = tri < 0
    assert 0.2 < sky.mean() < 0.8
    lin_z = regs[0][RS.MOTION][..., 2].numpy()
    np.testing.assert_array_equal(lin_z[sky], -1.0)
    assert (lin_z[~sky] > 0).all()


@pytest.mark.parametrize("kw", [{}, PACKET], ids=["default", "packet"])
def test_raytraced_matches_golden(kw):
    """tests/goldens/cube_raytraced_128.png (2 frames), by the port alone
    on the CPU, with the default kernels' plain versions and with K1v's
    and K2b's: off-edge max 16 u8, p99 2 (reading: 1 / 0 both)."""
    size = 128
    r = Renderer.for_scene(_settings(size, **kw),
                           port_scenes.cube_scene().build("cpu"))
    cam = OrbitCamera(width=size, height=size, **CUBE_CAM)
    for _ in range(2):
        img = to_u8(r.render_np(cam.step(taa_enabled=True)))
    tri = _edge_tri_ids(ref_scenes.cube_scene().build(),
                        RefCamera(width=size, height=size, **CUBE_CAM).step(),
                        size)
    off_max, p99 = off_edge_errors(img, read_png(GOLDEN), tri)
    assert off_max <= 16 and p99 <= 2.0, (off_max, p99)


@pytest.fixture(scope="module")
def stress_bins():
    """The reference's bins and the port's candidates of
    stress_scene(num_objects=10, seed=3) at 128x64, camera as in
    tests/test_raster_pallas.py:101."""
    W, H = 128, 64
    ref_data = ref_scenes.stress_scene(num_objects=10, seed=3).build()
    ref_cam = RefCamera(width=W, height=H, distance=30.0, pitch=0.5, yaw=0.8,
                        focal_point=(0, 2, 0)).step()
    clip = ref_raster.transform_to_clip(
        ref_data.vertices.world_position,
        jnp.asarray(ref_cam.proj) @ jnp.asarray(ref_cam.view))
    tris = ref_raster.clip_triangles(clip, ref_data.triangles.i0,
                                     ref_data.triangles.i1,
                                     ref_data.triangles.i2, W, H)
    packed, bbox, valid = raster_pallas.pack_candidates(tris)
    bins = raster_pallas.bin_candidates(packed, bbox, valid, W, H, 8, 128)

    data = scene_from_numpy(flatten(ref_data), "cpu")
    cam = _port_cam(ref_cam)
    vp = cam.proj @ cam.view
    soup = data.triangles
    corners = torch.stack([raster.transform_to_clip(v, vp)
                           for v in (soup.v0, soup.v1, soup.v2)], dim=1)
    rec, pbbox, pvalid = raster_cuda.pack_candidates(
        raster.clip_triangles(corners, W, H))
    ts, ec = raster_cuda.bin_candidates(pbbox, pvalid, W, H)
    clipped = (corners[..., 3] < raster.W_CLIP).any(1).numpy()
    return bins, (rec, ts, ec, W, H), clipped


@pytest.mark.parametrize("mode", ["v1", "v2", "v3"])
def test_vis_raster_matches_pallas_eval_modes(stress_bins, mode):
    """K1 vis-only against raster_tiles(eval_mode="v1", interpret=True),
    K1v against "v2" and "v3": every tri-id mismatch a near-tie (the two
    winners' depths within 2^-17; reading: 2 pixels of 8,192 for each
    mode), under 0.5% of pixels; where the ids agree, depth to 1e-6, off
    the one near-plane-clipped triangle (the floor, whose depth rounds
    apart by up to ~9e-6, ROADMAP queue 3)."""
    bins, (rec, ts, ec, W, H), clipped = stress_bins
    ref = raster_pallas.raster_tiles(bins, W, H, interpret=True,
                                     eval_mode=mode)
    vis, _ = raster_cuda.raster_tiles(rec, ts, ec, None, W, H,
                                      keyed=mode != "v1")
    tri, ref_tri = vis.tri_id.numpy(), np.asarray(ref.tri_id)
    depth, ref_depth = vis.depth.numpy(), np.asarray(ref.depth)
    assert (ref_tri >= 0).mean() > 0.1
    mis = tri != ref_tri
    assert mis.mean() < 0.005
    assert (np.abs(depth - ref_depth)[mis] <= 2.0 ** -17).all()
    agree = ~mis & (ref_tri >= 0)
    agree &= ~clipped[np.maximum(ref_tri, 0)]
    np.testing.assert_allclose(depth[agree], ref_depth[agree], rtol=0,
                               atol=1e-6)


def test_k1v_differs_from_k1_only_on_near_ties(stress_bins):
    """K1v's plain version against K1's on the same bins: the same
    outputs wherever the winner is the same; elsewhere the two winners'
    depths are within 2^-17 (reading: 11 of 8,192 pixels)."""
    _, (rec, ts, ec, W, H), _ = stress_bins
    k1, _ = raster_cuda.raster_tiles(rec, ts, ec, None, W, H)
    k1v, _ = raster_cuda.raster_tiles(rec, ts, ec, None, W, H, keyed=True)
    mis = k1.tri_id != k1v.tri_id
    assert 0 < int(mis.sum()) < 0.005 * mis.numel()
    assert ((k1.depth - k1v.depth).abs()[mis] <= 2.0 ** -17).all()
    for a, b in ((k1.depth, k1v.depth), (k1.bary1, k1v.bary1),
                 (k1.bary2, k1v.bary2)):
        torch.testing.assert_close(a[~mis], b[~mis], rtol=0, atol=0)


def test_keyed_raster_is_vis_only(stress_bins):
    """K1v's winner rule has no attribute stage: asking for one raises."""
    _, (rec, ts, ec, W, H), _ = stress_bins
    with pytest.raises(ValueError, match="vis-only"):
        raster_cuda.raster_tiles(rec, ts, ec, torch.zeros((1, 72)), W, H,
                                 keyed=True)


def _counting(monkeypatch, module, name, calls, label=None):
    """Record ``name`` in ``calls`` at each call of module.name, or
    ``label`` at each call that passes a true ``keyed``."""
    fn = getattr(module, name)

    def counted(*a, **kw):
        if label is None or kw.get("keyed"):
            calls.append(label or name)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, counted)


def test_runtime_entry_points(monkeypatch):
    """render_burst is K sequential renders with the same history;
    switch_path and apply_settings rebuild the pass stack, drop the
    history and keep, build or rebuild the tracer as the settings need;
    raster_eval "v2" / "v3" take the depth prepass through K1v and
    trace_backend "pallas" every query through K2b; an unknown value
    raises."""
    size = 32
    data = port_scenes.cube_scene().build("cpu")
    cams = [OrbitCamera(width=size, height=size, **CUBE_CAM) for _ in range(2)]
    states = []
    for _ in range(3):
        states.append(cams[0].step(taa_enabled=True))
        cams[0].orbit(0.05, 0.0)
    burst = Renderer.for_scene(_settings(size), data)
    seq = Renderer.for_scene(_settings(size), data)
    out = burst.render_burst(states)
    assert out.shape == (3, size, size, 3) and burst.frame_count == 3
    for i, cs in enumerate(states):
        torch.testing.assert_close(out[i], seq.render(cs), rtol=0, atol=0)
    assert burst.state.history.keys() == seq.state.history.keys()

    fwd = RenderSettings(width=size, height=size, path=RenderPathType.FORWARD,
                         flags=FLAGS)
    r = Renderer.for_scene(fwd, data)
    assert r.tracer is None
    r.render(states[0])
    r.switch_path(RenderPathType.RAYTRACED)
    assert r.path.kind == "raytraced" and r.frame_count == 0
    assert r.state.history == {} and r.tracer is not None
    fresh = Renderer.for_scene(_settings(size), data)
    torch.testing.assert_close(r.render(states[0]), fresh.render(states[0]),
                               rtol=0, atol=0)

    calls = []
    _counting(monkeypatch, raster_cuda, "raster_tiles", calls, "raster_vis")
    _counting(monkeypatch, trace, "intersect_packet", calls)
    tracer = r.tracer
    for kw in (dict(raster_eval="v3"), dict(raster_eval="v4"),
               dict(trace_backend="pallas-wide")):
        r.apply_settings(**kw)
        assert r.tracer is tracer and r.frame_count == 0
        calls.clear()
        r.render(states[0])
        assert calls == (["raster_vis"] if kw.get("raster_eval") == "v3"
                         else [])
    r.apply_settings(**PACKET)
    assert r.tracer is not tracer and r.tracer.packet
    calls.clear()
    img = r.render(states[0])
    assert calls == ["raster_vis", "intersect_packet", "intersect_packet"]
    packet = Renderer.for_scene(_settings(size, **PACKET), data)
    torch.testing.assert_close(img, packet.render(states[0]), rtol=0,
                               atol=0)
    with pytest.raises(ValueError):
        r.apply_settings(trace_backend="wide")


def test_triangle_ids_past_float_precision_raise():
    """Triangle ids ride the float32 raster record, exact below 2^24:
    pack_candidates refuses 2^24 triangles (two slots each) before it
    reads anything, for K1 with or without attributes and K1v alike."""
    def tris(n):
        ids = torch.zeros(1, dtype=torch.int32).expand(2 * n)
        return raster.ClippedTriangles(sxy=None, z=None, inv_w=None,
                                       bary=None, tri_id=ids, valid=None)

    with pytest.raises(ValueError, match="2\\^24"):
        raster_cuda.pack_candidates(tris(1 << 24))
    with pytest.raises(TypeError):   # below the limit it reads sxy
        raster_cuda.pack_candidates(tris((1 << 24) - 1))


@pytest.fixture(scope="module")
def demo_inputs():
    """The reference's 48x48 cube G-buffer and frame context
    (tests/test_demo_passes.py), and the port's over the same G-buffer
    with its own tracer."""
    gb, ref_ctx, settings = demo_setup()
    data = scene_from_numpy(flatten(ref_ctx.scene), "cpu")
    port_gb = GBuffer(**{k: torch.from_numpy(np.array(v))
                         for k, v in flatten(gb).items()})
    ctx = FrameContext(scene=data, cam=_port_cam(ref_ctx.cam),
                       params=FrameParams.create(data, frame_index=1),
                       settings=settings, state=None, history_valid=False,
                       shadow_query=trace.SceneTracer.build(data).shadow_query)
    return ({"_GBuffer": gb}, ref_ctx), ({"_GBuffer": port_gb}, ctx), settings


@pytest.mark.parametrize("name", ["rtao", "rayquery"])
def test_demo_pass_matches_reference(demo_inputs, name):
    """RTAOPass and RayQueryPass against the reference's: AO visibility
    on every pixel (reading: 0 of 2,304 differ); RayQuery's colour to
    1e-5 (reading: 8.9e-8), its shadow rays along the dFdx / dFdy face
    normal included (the cube has no sky texture: flat ambient)."""
    ref_inputs, port_inputs, settings = demo_inputs
    ref_fn = getattr(ref_rt_passes, f"make_{name}_pass")(settings)[0]
    fn, reads, writes, _ = getattr(rt_passes, f"make_{name}_pass")(settings)
    (key,) = writes
    want = np.asarray(ref_fn(*ref_inputs)[key])
    got = fn(*port_inputs)[key].numpy()
    assert reads == ("_GBuffer",) and got.shape == want.shape
    if name == "rtao":
        assert 0.0 < (want[..., 0] < 0.5).mean() < 1.0
        np.testing.assert_array_equal(got, want)
    else:
        assert want.max() > 0.05
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
