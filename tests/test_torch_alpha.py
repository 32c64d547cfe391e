"""Port vs reference: alpha-tested (cut-out) materials. The G-buffer's
alpha test of the cut-out raster layer, and the rays that skip
transparent texels: up to ALPHA_ROUNDS closest-hit rounds for shadow and
AO rays, ALPHA_ROUNDS - 1 re-traces for radiance rays. The reference
runs on its CPU paths (jnp raster and traversal); the port's rounds run
through the plain versions of its closest-hit kernels: K2c by default,
K2b under trace_backend="pallas". The first four tests are
tests/test_alpha.py's cases, port against reference."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridrenderer_tpu.core.camera import OrbitCamera as RefCamera
from hybridrenderer_tpu.core.config import RenderSettings as RefSettings
from hybridrenderer_tpu.core.types import RenderFlags as RefFlags
from hybridrenderer_tpu.core.types import RenderPathType as RefPath
from hybridrenderer_tpu.graph.params import FrameParams as RefFrameParams
from hybridrenderer_tpu.ops import gbuffer as ref_gbuffer
from hybridrenderer_tpu.ops import raster as ref_raster
from hybridrenderer_tpu.ops import trace as ref_trace
from hybridrenderer_tpu.runtime.renderer import Renderer as RefRenderer
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu.scene.schema import Material as RefMaterial
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType
from hybridrenderer_tpu_torch.graph.params import FrameParams
from hybridrenderer_tpu_torch.ops import gbuffer
from hybridrenderer_tpu_torch.ops.composition import view_directions
from hybridrenderer_tpu_torch.ops.trace import ALPHA_ROUNDS, SceneTracer
from hybridrenderer_tpu_torch.runtime.output import to_u8
from hybridrenderer_tpu_torch.runtime.renderer import Renderer
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

from .test_alpha import _cutout_scene as checker_scene
from .torch_parity import (clear_reference_knobs, flatten, off_edge_errors,
                          one_torch_thread)

CUTOUT_CAM = dict(distance=9.0, pitch=0.35, yaw=0.4, focal_point=(0, 1.2, 0))


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    clear_reference_knobs(monkeypatch)
    with one_torch_thread():
        yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _both(ref_data, settings=None):
    """(reference tracer, port tracer, port scene) of one scene."""
    data = scene_from_numpy(flatten(ref_data), "cpu")
    return (ref_trace.SceneTracer.build(ref_data),
            SceneTracer.build(data, settings), data)


def test_shadow_rays_pass_through_transparent_texels():
    """Rays straight up from the ground through the 8x8 alpha checker
    quad: the port's visibility equals the reference's, holes and solid
    texels both present."""
    ref_data = checker_scene().build()
    ref_tracer, tracer, _ = _both(ref_data)
    xs = np.linspace(-1.75, 1.75, 8, dtype=np.float32)
    pts = np.stack([np.repeat(xs, 8), np.full(64, 0.01, np.float32),
                    np.tile(xs, 8)], -1)
    up = np.tile(np.array([0, 1, 0], np.float32), (64, 1))
    want = np.asarray(ref_tracer.occluded(ref_data, jnp.asarray(pts),
                                          jnp.asarray(up), 100.0))
    vis = tracer.occluded(_t(pts), _t(up), 100.0,
                          torch.ones(64, dtype=torch.bool)).numpy()
    assert (want == 0.0).any() and (want == 1.0).any()
    np.testing.assert_array_equal(vis, want)


def test_opaque_scene_shadow_unchanged():
    """The same geometry without an alpha-tested material: the plain
    any-hit query, no rounds."""
    sc = checker_scene()
    sc.materials[1] = RefMaterial(name="g")
    ref_data = sc.build()
    ref_tracer, tracer, data = _both(ref_data)
    assert not data.has_alpha_test and tracer.cutout is None
    o = np.array([[0.0, 0.01, 0.0], [3.5, 0.01, 3.5]], np.float32)
    d = np.array([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    want = np.asarray(ref_tracer.occluded(ref_data, jnp.asarray(o),
                                          jnp.asarray(d), 100.0))
    vis = tracer.occluded(_t(o), _t(d), 100.0,
                          torch.ones(2, dtype=torch.bool)).numpy()
    np.testing.assert_array_equal(vis, want)
    assert vis[0] == 0.0 and vis[1] == 1.0


def test_gbuffer_cutout_discard():
    """Forward frame looking straight down at the checker quad: the
    two-layer G-buffer shows the green solid texels and the grey ground
    through the holes, to 2 u8 off triangle edges, p99 1."""
    ref_data = checker_scene().build()
    size = 96
    cam_kw = dict(distance=6.0, pitch=1.35, focal_point=(0, 0, 0))
    ref = RefRenderer.for_scene(RefSettings(
        width=size, height=size, path=RefPath.FORWARD, flags=RefFlags.LIGHT,
        raster_backend="jnp"), ref_data)
    ref_state = RefCamera(width=size, height=size, **cam_kw).step()
    want = to_u8(np.asarray(ref.render(ref_state)))
    r = Renderer.for_scene(RenderSettings(
        width=size, height=size, path=RenderPathType.FORWARD,
        flags=RenderFlags.LIGHT), scene_from_numpy(flatten(ref_data), "cpu"))
    img = r.render_np(OrbitCamera(width=size, height=size, **cam_kw).step())
    green = (img[..., 1] > img[..., 0] * 1.5)[24:72, 24:72]
    assert 0.1 < green.mean() < 0.9
    soup = ref_data.triangles
    tri = np.asarray(ref_raster.rasterize_scene(
        ref_data.vertices.world_position, soup.i0, soup.i1, soup.i2,
        ref_state, size, size, jitter_enabled=False).tri_id)
    off_max, p99 = off_edge_errors(to_u8(img), want, tri)
    assert off_max <= 2 and p99 <= 1.0, (off_max, p99)


def _radiance_ctx(ref_data, data, flags):
    ref_ctx = types.SimpleNamespace(
        settings=RefSettings(flags=RefFlags(int(flags))),
        params=RefFrameParams.create(ref_data, frame_index=3))
    ctx = types.SimpleNamespace(settings=RenderSettings(flags=flags),
                                params=FrameParams.create(data,
                                                          frame_index=3))
    return ref_ctx, ctx


def test_radiance_skips_transparent_texels():
    """Downward radiance rays over the checker quad, a 32x32 image: rays
    through a hole hit the ground 5 below, solid texels the quad 3
    below; hit distances and shading equal the reference's."""
    ref_data = checker_scene().build()
    ref_tracer, tracer, data = _both(ref_data)
    xs = np.linspace(-1.9, 1.9, 32, dtype=np.float32)
    o = np.stack(np.broadcast_arrays(xs[None, :], np.float32(5.0),
                                     xs[:, None]), -1).astype(np.float32)
    d = np.broadcast_to(np.array([0, -1, 0], np.float32), o.shape).copy()
    flags = RenderFlags.LIGHT | RenderFlags.IBL
    ref_ctx, ctx = _radiance_ctx(ref_data, data, flags)
    want_rgb, want_dist = (np.asarray(x) for x in ref_tracer.trace_radiance(
        ref_data, jnp.asarray(o), jnp.asarray(d), ref_ctx, 0))
    rgb, dist = tracer.trace_radiance(data, _t(o), _t(d), ctx, 0)
    assert np.isclose(want_dist, 5.0, atol=1e-3).any()
    assert np.isclose(want_dist, 3.0, atol=1e-3).any()
    np.testing.assert_allclose(dist.numpy(), want_dist, rtol=1e-5)
    np.testing.assert_allclose(rgb.numpy(), want_rgb, rtol=1e-4, atol=1e-5)


def test_cutout_alpha_pass_matches_reference():
    """The alpha test from the cut-out layer's attribute image (uv at
    13:15, colour texture at 26, cutoff at 31): seeded attributes with
    texture ids -1 and 0, cutoffs across [0, 1]."""
    ref_data = ref_scenes.cutout_scene().build()
    data = scene_from_numpy(flatten(ref_data), "cpu")
    g = np.random.default_rng(0)
    a = g.uniform(-1.5, 2.5, (48, 40, 40)).astype(np.float32)
    a[..., 26] = g.choice([-1.0, 0.0], (48, 40))
    a[..., 31] = g.uniform(0.0, 1.0, (48, 40))
    vis = ref_raster.VisibilityBuffer(
        tri_id=jnp.zeros((48, 40), jnp.int32), bary1=jnp.zeros((48, 40)),
        bary2=jnp.zeros((48, 40)), depth=jnp.ones((48, 40)))
    want = np.asarray(ref_gbuffer.cutout_alpha_pass(
        vis, ref_data, kernel_attrs=jnp.asarray(a)))
    got = gbuffer.cutout_alpha_pass(data, _t(a)).numpy()
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got, want)


def _shadow_queries(data, settings, size=32):
    """The shadow and AO queries of one port frame of the cut-out scene,
    as the passes hand them to the tracer: [(args, kwargs)]."""
    r = Renderer.for_scene(settings, data)
    tracer, query, calls = r.tracer, r.tracer.shadow_query, []

    def recording(*a, **kw):
        calls.append((a, kw))
        return query(*a, **kw)

    tracer.shadow_query = recording
    r.render(OrbitCamera(width=size, height=size, **CUTOUT_CAM).step())
    del tracer.shadow_query
    return tracer, calls


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_alpha_rounds_match_reference(backend):
    """The shadow and AO queries of a 32x32 hybrid frame of the cut-out
    scene, through ALPHA_ROUNDS closest-hit rounds of the plain K2c
    ("auto") or the plain K2b ("pallas"), against the reference's jnp
    rounds. K2b's visiting order is its packet's, so a ray whose closest
    hits tie in t may take the other one; visibility may differ on at
    most 1e-3 of the rays. Radiance rays of that frame's pixels are held
    to the reference too."""
    ref_data = ref_scenes.cutout_scene().build()
    data = scene_from_numpy(flatten(ref_data), "cpu")
    size = 32
    settings = RenderSettings(width=size, height=size,
                              path=RenderPathType.HYBRID,
                              flags=RenderFlags.default_hybrid(), ao_block=8,
                              gi_block=8, trace_backend=backend)
    tracer, calls = _shadow_queries(data, settings, size)
    assert tracer.cutout is not None and tracer.packet == (backend
                                                           == "pallas")
    assert len(calls) == 2
    ref_tracer = ref_trace.SceneTracer.build(ref_data)
    skipped = 0
    for (wp, n, direction, tmax), kw in calls:
        vis = tracer.shadow_query(wp, n, direction, tmax, **kw).numpy()
        want = np.asarray(ref_tracer.shadow_query(
            ref_data, jnp.asarray(wp.numpy()), jnp.asarray(n.numpy()),
            jnp.asarray(direction.expand_as(wp).numpy()), tmax,
            active=jnp.asarray(kw["active"].numpy())))
        assert (vis != want).mean() <= 1e-3
        # the rays that the first round finds on a transparent texel
        o, d, t, act = tracer.shadow_rays(wp, n, direction, tmax,
                                          kw["active"])
        _, tri, u, v = tracer._closest(o, d, 0.01, t, act, size)
        is_mask, alpha, cutoff = tracer.surface_alpha(tri, u, v)
        skipped += int((act & (tri >= 0) & is_mask & (alpha < cutoff)).sum())
    assert skipped > 0 and ALPHA_ROUNDS == 4
    # primary-like radiance rays from the camera through every pixel
    cpu = torch.device("cpu")
    cam = OrbitCamera(width=size, height=size, **CUTOUT_CAM).step().to(cpu)
    d = view_directions(cam, size, size, cpu)
    o = cam.position.expand_as(d)
    flags = RenderFlags.LIGHT | RenderFlags.IBL
    ref_ctx, ctx = _radiance_ctx(ref_data, data, flags)
    rgb, dist = tracer.trace_radiance(data, o, d, ctx, 0)
    want_rgb, want_dist = (np.asarray(x) for x in ref_tracer.trace_radiance(
        ref_data, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), ref_ctx, 0))
    same = np.isclose(dist.numpy(), want_dist, rtol=1e-5)
    assert same.mean() >= 1 - 1e-3
    np.testing.assert_allclose(rgb.numpy()[same], want_rgb[same], rtol=1e-4,
                               atol=1e-5)
