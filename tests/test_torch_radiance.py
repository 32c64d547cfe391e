"""Port vs reference: closest-hit traversal (the plain version of K2c)
against ops/trace.py intersect_bvh(any_hit=False), the radiance query
(K2c + hit shading + sky) and the occlusion query against the reference
SceneTracer, and the single-signal temporal entry (K3s) against
temporal_pallas.reproject in interpret mode."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridrenderer_tpu.core.config import RenderSettings as RefSettings
from hybridrenderer_tpu.core.types import RenderFlags as RefFlags
from hybridrenderer_tpu.graph.params import FrameParams as RefFrameParams
from hybridrenderer_tpu.ops import bvh as ref_bvh
from hybridrenderer_tpu.ops import temporal_pallas
from hybridrenderer_tpu.ops import trace as ref_trace
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType
from hybridrenderer_tpu_torch.graph.params import FrameParams
from hybridrenderer_tpu_torch.ops import temporal_cuda, trace_cuda
from hybridrenderer_tpu_torch.ops.trace import (RADIANCE_TMIN, SceneTracer)
from hybridrenderer_tpu_torch.runtime.renderer import Renderer
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

from .test_torch_slice import CORNELL_CAM, CUBE_CAM
from .test_torch_trace import _rays
from .torch_parity import clear_reference_knobs, flatten, one_torch_thread

STRESS_CAM = dict(distance=18.0, pitch=0.5, yaw=0.8, focal_point=(0, 2.0, 0))
FULL = RenderFlags.default_hybrid() | RenderFlags.REFLECTION | RenderFlags.GI


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    clear_reference_knobs(monkeypatch)
    with one_torch_thread():
        yield


def frame_radiance_rays(data, size, cam_kw, flags=FULL):
    """The radiance queries of one port frame at size x size, as
    (origin (H, W, 3), direction (H, W, 3), active (H, W)) per query
    (reflection, then GI), recorded as the passes hand them over."""
    r = Renderer.for_scene(
        RenderSettings(width=size, height=size, path=RenderPathType.HYBRID,
                       flags=flags, ao_block=8, gi_block=8), data)
    tracer, trace, calls = r.tracer, r.tracer.trace_radiance, []

    def recording(scene, origin, direction, ctx, depth=0, active=None):
        calls.append((origin, direction, active))
        return trace(scene, origin, direction, ctx, depth, active=active)

    tracer.trace_radiance = recording
    r.render(OrbitCamera(width=size, height=size, **cam_kw).step())
    del tracer.trace_radiance
    return tracer, calls


def test_closest_hit_matches_reference():
    """stress_scene(8, seed=3): random rays, and the reflection and GI
    rays of a 32x32 frame. Triangle ids agree except on at most 1e-3 of
    the rays (equal-t ties on shared edges); t to 1e-5 relative, u and v,
    which lie in [0, 1], to 1e-5 of that range (each is a dot product
    whose terms cancel, so a small u carries the terms' rounding)."""
    ref_data = ref_scenes.stress_scene(num_objects=8, seed=3).build()
    soup = ref_data.triangles
    tree = ref_bvh.build_bvh_host(soup.v0, soup.v1, soup.v2, "sah")
    data = scene_from_numpy(flatten(ref_data), "cpu")
    tracer, calls = frame_radiance_rays(data, 32, STRESS_CAM)
    o, d, tmax, active = _rays(4096, 1)
    tmax = np.where(np.random.default_rng(2).random(4096) < 0.5, 1e6, tmax)
    batches = [(o, d, tmax.astype(np.float32), active)]
    for origin, direction, act in calls:
        ro, rd, rt, ra = tracer.radiance_rays(origin, direction, act)
        batches.append((ro.numpy(), rd.numpy(), rt.numpy(), ra.numpy()))
    assert len(batches) == 3
    for o, d, tmax, active in batches:
        # the reference's CPU backend passes inactive rays as tmax 0
        ref = [np.asarray(x) for x in ref_trace.intersect_bvh(
            tree, soup.v0, soup.v1, soup.v2, jnp.asarray(o), jnp.asarray(d),
            RADIANCE_TMIN, jnp.asarray(np.where(active, tmax, 0.0)),
            any_hit=False)]
        out = [x.numpy() for x in trace_cuda.intersect_closest(
            tracer.packed, torch.from_numpy(o), torch.from_numpy(d),
            RADIANCE_TMIN, torch.from_numpy(tmax), torch.from_numpy(active))]
        assert 0.05 < (ref[1] >= 0).mean() < 1.0
        same = out[1] == ref[1]
        assert (~same).mean() <= 1e-3
        hit = same & (ref[1] >= 0)
        np.testing.assert_allclose(out[0][hit], ref[0][hit], rtol=1e-5)
        for k in (2, 3):
            np.testing.assert_allclose(out[k][hit], ref[k][hit], rtol=0,
                                       atol=1e-5)
        assert np.isinf(out[0][out[1] < 0]).all()
        assert (out[1][~active] == -1).all()


@pytest.mark.parametrize("scene,flags", [
    ("cornell", FULL),
    ("cornell", FULL & ~RenderFlags.LIGHT),
    ("cube", FULL & ~RenderFlags.IBL),
])
def test_trace_radiance_matches_reference(scene, flags):
    """SceneTracer.trace_radiance on the reflection and GI rays of a
    32x32 frame: cornell's NEE area light with the sun ray fused in or
    alone, the cube's sun without IBL. rgb to 1e-4 relative plus 1e-5
    absolute; hit distance to 1e-5 where both hit."""
    scene_fn, cam_kw = {"cornell": (ref_scenes.cornell_scene, CORNELL_CAM),
                        "cube": (ref_scenes.cube_scene, CUBE_CAM)}[scene]
    ref_data = scene_fn().build()
    data = scene_from_numpy(flatten(ref_data), "cpu")
    tracer, calls = frame_radiance_rays(data, 32, cam_kw, flags)
    ref_tracer = ref_trace.SceneTracer.build(ref_data)
    ref_ctx = types.SimpleNamespace(
        settings=RefSettings(flags=RefFlags(int(flags))),
        params=RefFrameParams.create(ref_data, frame_index=5))
    ctx = types.SimpleNamespace(
        settings=RenderSettings(flags=flags),
        params=FrameParams.create(data, frame_index=5))
    ref_query = jax.jit(lambda o, d, a: ref_tracer.trace_radiance(
        ref_data, o, d, ref_ctx, 0, active=a))
    for origin, direction, active in calls:
        rgb, dist = tracer.trace_radiance(data, origin, direction, ctx, 0,
                                          active=active)
        ref_rgb, ref_dist = (np.asarray(x) for x in ref_query(
            jnp.asarray(origin.numpy()), jnp.asarray(direction.numpy()),
            jnp.asarray(active.numpy())))
        assert (ref_dist > 0).any() and ref_rgb.max() > 0.0
        np.testing.assert_allclose(rgb.numpy(), ref_rgb, rtol=1e-4,
                                   atol=1e-5)
        both = (dist.numpy() > 0) & (ref_dist > 0)
        np.testing.assert_allclose(dist.numpy()[both], ref_dist[both],
                                   rtol=1e-5)


def test_occluded_matches_reference():
    """Flat any-hit visibility, tmin 1e-3: 1.0 unoccluded, 0.0 occluded;
    inactive rays report 0.0."""
    ref_data = ref_scenes.stress_scene(num_objects=8, seed=3).build()
    tracer = SceneTracer.build(scene_from_numpy(flatten(ref_data), "cpu"))
    o, d, _, active = _rays(4096, 3)
    ref = np.asarray(ref_trace.SceneTracer.build(ref_data).occluded(
        ref_data, jnp.asarray(o), jnp.asarray(d), 1000.0,
        active=jnp.asarray(active)))
    vis = tracer.occluded(torch.from_numpy(o), torch.from_numpy(d), 1000.0,
                          torch.from_numpy(active)).numpy()
    assert 0.1 < (ref[active] == 0.0).mean() < 0.9
    assert (vis[active] != ref[active]).mean() <= 1e-3
    assert (vis[~active] == 0.0).all()


def test_reproject_matches_pallas():
    """temporal_cuda.reproject, the reference's single-signal entry over
    K3, against temporal_pallas.reproject(interpret=True) at 32x32, with
    motion smooth enough that every footprint lies in its tile window."""
    g = np.random.default_rng(11)
    H = W = 32
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    motion = np.stack([0.02 * np.sin(yy / 9.0), 0.015 * np.cos(xx / 7.0)],
                      -1).astype(np.float32)
    z = (4.0 + 0.1 * yy + 0.02 * g.random((H, W))).astype(np.float32)
    oid = ((xx // 11) % 3).astype(np.int32)
    nrm = np.stack([0.1 * g.standard_normal((H, W)), np.ones((H, W)),
                    0.1 * g.standard_normal((H, W))], -1).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    hpack = np.concatenate([
        g.random((7, H, W)), np.moveaxis(nrm, -1, 0), (z * 1.01)[None],
        oid[None]]).astype(np.float32)
    hpack[8, 5:9] = -1.0          # a band of rejected normals
    # footprints as the reference's temporal_multi computes them
    uv = np.stack([(xx + 0.5) / W, (yy + 0.5) / H], -1).astype(np.float32)
    prev_pix = (uv - motion) * np.array([W, H], np.float32) - 0.5
    base = np.clip(np.floor(prev_pix), 0.0,
                   np.array([W - 2, H - 2], np.float32))
    f = prev_pix - base
    ok = ((prev_pix[..., 0] >= 0) & (prev_pix[..., 0] <= W - 1)
          & (prev_pix[..., 1] >= 0) & (prev_pix[..., 1] <= H - 1))
    ref = temporal_pallas.reproject(
        jnp.asarray(hpack), jnp.asarray(base[..., 1].astype(np.int32)),
        jnp.asarray(base[..., 0].astype(np.int32)), jnp.asarray(f[..., 1]),
        jnp.asarray(f[..., 0]), jnp.asarray(ok), jnp.asarray(nrm),
        jnp.asarray(z), jnp.asarray(oid.astype(np.float32)), interpret=True)
    out = temporal_cuda.reproject(
        torch.from_numpy(hpack), torch.from_numpy(motion),
        torch.from_numpy(nrm), torch.from_numpy(z), torch.from_numpy(oid))
    wsum = np.asarray(ref[3])
    assert (wsum > 0.99).mean() > 0.5 and (wsum == 0.0).mean() > 0.05
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
