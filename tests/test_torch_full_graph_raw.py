"""Port vs reference: the full graph with SVGF off — the G-buffer,
shading and the raw 1-spp shadow, AO, reflection and GI signals, which
carry no SVGF chaos — held to 2 u8 / p99 1 off edges, every frame.

"Edges" are the primary rays' triangle edges (bench.py's rule) and the
pixels whose reflection or GI ray hits another triangle in the port than
in the reference (each package's own traversal on its own rays). Such a
ray grazes an edge: the port's G-buffer positions (raster kernel K1)
differ from the reference's jnp rasterizer by up to ~1e-3 units, and at
64x64 one GI ray of the cube's first frame, grazing the cube's vertical
edge, hit the other face. Those pixels stay a small share of the image
(SECONDARY_FLIP_MAX)."""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridrenderer_tpu.core.camera import OrbitCamera as RefCamera
from hybridrenderer_tpu.core.types import RenderFlags as RefFlags
from hybridrenderer_tpu.ops import image as ref_image
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.types import DisplayMode, RenderFlags
from hybridrenderer_tpu_torch.graph.params import RS
from hybridrenderer_tpu_torch.ops import image
from hybridrenderer_tpu_torch.ops import postprocess as post_ops
from hybridrenderer_tpu_torch.ops.image import tri_boundary_mask
from hybridrenderer_tpu_torch.ops.trace import (HIT_ID_LIMIT, RADIANCE_TMAX,
                                                RADIANCE_TMIN)
from hybridrenderer_tpu_torch.runtime.output import to_u8
from hybridrenderer_tpu_torch.runtime.renderer import Renderer
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

from .test_torch_full_graph import FULL, REF_FULL, check_full_graph
from .test_torch_slice import (CASES, _edge_tri_ids, _settings,
                               reference_renderer)
from .torch_parity import (clear_reference_knobs, flatten,
                           one_torch_thread, record_secondary_hits)

REF_NO_SVGF = ~(RefFlags.SVGF | RefFlags.SVGF_TEMPORAL
                | RefFlags.SVGF_SPATIAL)
NO_SVGF = ~(RenderFlags.SVGF | RenderFlags.SVGF_TEMPORAL
            | RenderFlags.SVGF_SPATIAL)


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    clear_reference_knobs(monkeypatch)
    with one_torch_thread():
        yield


# the share of pixels off the primary edges whose secondary hit may
# differ from the reference's (reading: 1 pixel of 4,096 on the cube's
# first two frames, none on any other frame or case)
SECONDARY_FLIP_MAX = 2e-3


@contextlib.contextmanager
def _reference_secondary_hits(ref, ref_data):
    """While open, each full-resolution radiance query of the reference
    renderer ``ref`` sends its rays to the host (jax.debug.callback, in
    program order). The yielded function traces the rays sent since its
    last call with the reference's own traversal (intersect_bvh through
    SceneTracer._intersect, tmin 0.01, tmax 1e6) and hands out their hit
    triangles as record_secondary_hits does."""
    cls = type(ref.tracer)
    trace = cls.trace_radiance
    H, W = ref.settings.height, ref.settings.width
    rays = []

    def sink(o, d, a):
        rays.append((np.asarray(o), np.asarray(d), np.asarray(a)))

    def recording(self, scene, origin, direction, ctx, depth=0, active=None,
                  **kw):
        if origin.shape[:2] == (H, W):
            jax.debug.callback(sink, origin, direction, active, ordered=True)
        return trace(self, scene, origin, direction, ctx, depth,
                     active=active, **kw)

    def take():
        jax.effects_barrier()
        out = []
        for o, d, a in rays:
            act = a.reshape(-1)
            _, tri, _, _ = ref.tracer._intersect(
                ref_data, jnp.asarray(o.reshape(-1, 3)),
                jnp.asarray(d.reshape(-1, 3)), RADIANCE_TMIN, RADIANCE_TMAX,
                any_hit=False, active=jnp.asarray(act))
            tri = np.asarray(tri)
            hit = (tri >= 0) & (tri < HIT_ID_LIMIT) & act
            out.append(np.where(act, np.where(hit, tri, -1),
                                -2).reshape(H, W))
        rays.clear()
        return out

    cls.trace_radiance = recording
    try:
        yield take
    finally:
        cls.trace_radiance = trace


def _edge_mask(edges, port_hits, ref_hits):
    """The primary rays' triangle edges ``edges`` and the pixels off them
    where a secondary ray of the port hit another triangle than the
    reference's; the share of the latter is held to SECONDARY_FLIP_MAX."""
    assert len(port_hits) == len(ref_hits) > 0
    flips = np.zeros(edges.shape, bool)
    for mine, theirs in zip(port_hits, ref_hits):
        flips |= mine != theirs
    flips &= ~edges
    assert flips.mean() <= SECONDARY_FLIP_MAX, flips.mean()
    return edges | flips


def _off_edge(img, ref_img, mask):
    diff = np.abs(img.astype(int) - ref_img.astype(int))
    return int(diff.max(axis=-1)[~mask].max()), float(np.percentile(diff,
                                                                    99))


def _stash_planes(renderer, sink):
    """Make each frame of ``renderer`` (either package's) hand its
    ReflectionRaw and GIRaw planes to ``sink``: the reference's through
    its frame statistics, which its jitted frame function returns."""
    run = renderer.path.run

    def stashing(ctx, state):
        out, new_state, reg = run(ctx, state)
        planes = (reg[RS.REFLECTION_RAW], reg[RS.GI_RAW])
        if isinstance(renderer, Renderer):
            sink.append(planes)
        else:
            reg["_FrameStats"] = planes
        return out, new_state, reg

    renderer.path.run = stashing


def _u8(plane):
    """A raw signal as its display mode shows it: tonemapped at exposure
    1 (CompositionPass passes REFLECTION and GI through)."""
    return to_u8(post_ops.tonemap(torch.from_numpy(np.array(plane))[..., :3],
                                  1.0).numpy())


@functools.cache
def _svgf_off_frames(case):
    """3 frames of the full graph with SVGF off, 64x64, the reference
    jitted: per frame {mode: (port u8, reference u8)} and the edge mask.
    One reference compile serves FINAL, REFLECTION and GI."""
    scene_fn, cam_kw, _, _ = CASES[case]
    size = 64
    ref_data = scene_fn().build()
    ref = reference_renderer(ref_data, size, REF_FULL & REF_NO_SVGF)
    port = Renderer.for_scene(_settings(size).replace(flags=FULL & NO_SVGF),
                              scene_from_numpy(flatten(ref_data), "cpu"))
    planes = []
    _stash_planes(ref, planes)
    _stash_planes(port, planes)
    port_hits = record_secondary_hits(port)
    ref_cam = RefCamera(width=size, height=size, **cam_kw)
    cam = OrbitCamera(width=size, height=size, **cam_kw)
    frames = []
    with _reference_secondary_hits(ref, ref_data) as ref_hits:
        for _ in range(3):
            ref_state = ref_cam.step()
            images = {DisplayMode.FINAL: (
                to_u8(port.render_np(cam.step())),
                to_u8(np.asarray(ref.render(ref_state))))}
            for mode, mine, theirs in zip(
                    (DisplayMode.REFLECTION, DisplayMode.GI), planes.pop(),
                    ref._stats):
                images[mode] = (_u8(mine), _u8(theirs))
            mask = _edge_mask(tri_boundary_mask(
                _edge_tri_ids(ref_data, ref_state, size), dilate=1),
                port_hits(), ref_hits())
            frames.append((images, mask))
    return frames


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode", [DisplayMode.FINAL, DisplayMode.REFLECTION,
                                  DisplayMode.GI])
def test_full_graph_before_svgf_matches_reference(case, mode):
    """SVGF off, 64x64, 3 frames: FINAL composes every signal;
    REFLECTION and GI are the raw signals as their display modes show
    them."""
    for frame, (images, mask) in enumerate(_svgf_off_frames(case)):
        img, ref_img = images[mode]
        assert ref_img.std() > 0.0
        off_max, p99 = _off_edge(img, ref_img, mask)
        assert off_max <= 2 and p99 <= 1.0, (frame, off_max, p99)


def test_cube_full_graph_matches_reference():
    """The full graph with SVGF on, cube case (the cornell case is in
    tests/test_torch_full_graph.py, which holds both gates)."""
    check_full_graph("cube")


@pytest.mark.parametrize("option,mode", [
    (dict(reflection_half_res=True), DisplayMode.REFLECTION),
    (dict(gi_half_res=True), DisplayMode.GI),
    (dict(gi_interleaved=False), DisplayMode.GI),
    (dict(gi_interleaved=False, use_blue_noise=False), DisplayMode.GI),
    (dict(reflection_roughness_cutoff=0.95), DisplayMode.REFLECTION),
])
def test_full_graph_options_match_reference(option, mode):
    """The half-res reflection and GI grids (depth-aware upsample), the
    per-pixel GI draws (blue noise, TEA hash) and a roughness cutoff
    above the walls' 0.9 (every surface reflects), cornell, SVGF off,
    one 48x48 frame."""
    from hybridrenderer_tpu.core.config import RenderSettings as RefSettings
    from hybridrenderer_tpu.core.types import DisplayMode as RefMode
    from hybridrenderer_tpu.core.types import RenderPathType as RefPath
    from hybridrenderer_tpu.runtime.renderer import Renderer as RefRenderer

    scene_fn, cam_kw, _, _ = CASES["cornell"]
    size = 48
    ref_data = scene_fn().build()
    ref = RefRenderer.for_scene(
        RefSettings(width=size, height=size, path=RefPath.HYBRID,
                    flags=REF_FULL & REF_NO_SVGF, display_mode=RefMode(mode),
                    ao_block=8, gi_block=8, raster_backend="jnp",
                    trace_backend="jnp", svgf_backend="jnp",
                    svgf_temporal_gather="pixel", **option), ref_data)
    port = Renderer.for_scene(
        _settings(size, display_mode=mode, **option).replace(
            flags=FULL & NO_SVGF), scene_from_numpy(flatten(ref_data), "cpu"))
    port_hits = record_secondary_hits(port)
    img = to_u8(port.render_np(OrbitCamera(width=size, height=size,
                                           **cam_kw).step()))
    ref_state = RefCamera(width=size, height=size, **cam_kw).step()
    with _reference_secondary_hits(ref, ref_data) as ref_hits:
        ref_img = to_u8(np.asarray(ref.render(ref_state)))
        mask = _edge_mask(tri_boundary_mask(
            _edge_tri_ids(ref_data, ref_state, size), dilate=1),
            port_hits(), ref_hits())
    assert ref_img.std() > 0.0
    off_max, p99 = _off_edge(img, ref_img, mask)
    assert off_max <= 2 and p99 <= 1.0, (off_max, p99)


def test_depth_aware_upsample_matches_reference():
    g = np.random.default_rng(4)
    z_full = (2.0 + g.random((19, 26))).astype(np.float32)
    z_full[5:9, 3:12] += 4.0
    z_half = z_full[::2, ::2]
    for val in (g.random((10, 13, 3)).astype(np.float32),
                g.random((10, 13)).astype(np.float32)):
        ref = np.asarray(ref_image.upsample2x_depth_aware(val, z_half,
                                                          z_full))
        out = image.upsample2x_depth_aware(torch.from_numpy(val),
                                           torch.from_numpy(z_half.copy()),
                                           torch.from_numpy(z_full)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
