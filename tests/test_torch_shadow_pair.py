"""Port vs reference: the fused shadow + AO query,
``SceneTracer.shadow_query_pair`` (the reference's ops/trace.py
shadow_query_pair, jnp backend), and RTShadowPass's fused branch under
``fuse_shadow_ao`` (the reference's RT_FUSE_SHADOW_AO), which must give
the unfused frame bit for bit with one any-hit launch instead of two."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridrenderer_tpu.ops import trace as ref_trace
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType
from hybridrenderer_tpu_torch.runtime.renderer import Renderer
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

from .torch_parity import clear_reference_knobs, flatten, one_torch_thread

SIZE = 32
CAMS = {"cube": dict(distance=7.0, pitch=0.45, yaw=0.6,
                     focal_point=(0, 0.7, 0)),
        "cutout": dict(distance=9.0, pitch=0.35, yaw=0.4,
                       focal_point=(0, 1.2, 0))}
SCENES = {"cube": ref_scenes.cube_scene, "cutout": ref_scenes.cutout_scene}


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    clear_reference_knobs(monkeypatch)
    with one_torch_thread():
        yield


def _settings(**kw):
    return RenderSettings(width=SIZE, height=SIZE, path=RenderPathType.HYBRID,
                          flags=RenderFlags.default_hybrid(), ao_block=8,
                          **kw)


def _frame_queries(data, name):
    """The shadow and AO queries of one unfused hybrid frame, as
    RTShadowPass hands them to the tracer → (tracer, [(args, kwargs)])."""
    r = Renderer.for_scene(_settings(), data)
    tracer, query, calls = r.tracer, r.tracer.shadow_query, []

    def recording(*a, **kw):
        calls.append((a, kw))
        return query(*a, **kw)

    tracer.shadow_query = recording
    r.render(OrbitCamera(width=SIZE, height=SIZE, **CAMS[name]).step())
    del tracer.shadow_query
    return tracer, calls


@pytest.mark.parametrize("name", sorted(SCENES))
def test_pair_matches_reference(name):
    """A hybrid frame's shadow and AO queries (the cut-out scene's
    through the alpha rounds) as one pair: equal to the port's two
    shadow_query calls bit for bit, and to the reference's
    shadow_query_pair (jnp backend) on at least 1 - 1e-3 of the rays, the
    gate of tests/test_torch_trace.py. Each half's tmax is its number,
    capped at 10000: the reference's scalar tmax (ROADMAP queue 3,
    ops/trace.py:532), matched on purpose, so the shadow ray's 1e10 and
    10000 give the same pair."""
    ref_data = SCENES[name]().build()
    data = scene_from_numpy(flatten(ref_data), "cpu")
    tracer, calls = _frame_queries(data, name)
    assert len(calls) == 2 and (tracer.cutout is not None) == (name
                                                              == "cutout")
    (wp, n, d_a, t_a), kw = calls[0]
    (_, _, d_b, t_b), _ = calls[1]
    act = kw["active"]
    vis_a, vis_b = tracer.shadow_query_pair(wp, n, d_a, t_a, d_b, t_b,
                                            active=act)
    for vis, (args, k) in zip((vis_a, vis_b), calls):
        assert torch.equal(vis, tracer.shadow_query(*args, **k))
    capped = tracer.shadow_query_pair(wp, n, d_a, 10000.0, d_b, t_b,
                                      active=act)
    assert torch.equal(capped[0], vis_a) and torch.equal(capped[1], vis_b)
    ref_tracer = ref_trace.SceneTracer.build(ref_data)
    j = lambda x: jnp.asarray(x.expand_as(wp).numpy())
    want = ref_tracer.shadow_query_pair(
        ref_data, j(wp), j(n), j(d_a), t_a, j(d_b), t_b,
        active=jnp.asarray(act.numpy()))
    for vis, ref in zip((vis_a, vis_b), want):
        ref = np.asarray(ref)
        m = act.numpy()
        assert 0.0 < (ref[m] == 0.0).mean() < 1.0
        assert (vis.numpy()[m] != ref[m]).mean() <= 1e-3


@pytest.mark.parametrize("name,backend", [("cube", "auto"),
                                          ("cube", "pallas"),
                                          ("cutout", "auto")])
def test_fused_frame_equals_unfused(name, backend):
    """Two hybrid frames with fuse_shadow_ao on equal the unfused frames
    bit for bit (the packet traversal K2b's too); the fused frame makes
    one any-hit traversal call where the unfused one makes two (the
    cut-out scene's alpha rounds: one set of closest-hit rounds instead
    of two)."""
    data = scene_from_numpy(flatten(SCENES[name]().build()), "cpu")
    frames, calls = {}, {}
    for fuse in (False, True):
        r = Renderer.for_scene(_settings(fuse_shadow_ao=fuse,
                                         trace_backend=backend), data)
        cam = OrbitCamera(width=SIZE, height=SIZE, **CAMS[name])
        tracer, n = r.tracer, [0]
        traverse = "_closest" if tracer.cutout is not None else "_any"
        inner = getattr(tracer, traverse)

        def counting(*a, **kw):
            n[0] += 1
            return inner(*a, **kw)

        setattr(tracer, traverse, counting)
        frames[fuse] = [r.render_np(cam.step()) for _ in range(2)]
        calls[fuse] = n[0]
    for a, b in zip(frames[False], frames[True]):
        np.testing.assert_array_equal(a, b)
    assert calls[True] * 2 == calls[False] > 0


def test_fuse_needs_interleaved_ao():
    """Per-pixel AO draws (ao_interleaved off) keep the two queries, as
    the reference's fused branch asks for interleaved AO."""
    data = scene_from_numpy(flatten(ref_scenes.cube_scene().build()), "cpu")
    r = Renderer.for_scene(_settings(fuse_shadow_ao=True,
                                     ao_interleaved=False), data)
    pairs = []
    pair = r.tracer.shadow_query_pair
    r.tracer.shadow_query_pair = lambda *a, **kw: pairs.append(1) or pair(
        *a, **kw)
    r.render(OrbitCamera(width=SIZE, height=SIZE, **CAMS["cube"]).step())
    assert not pairs
