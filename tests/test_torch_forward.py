"""Port vs reference: the forward path (G-buffer → ForwardPass → TAA →
post-process) and its history fetch, kernel K5, on the CPU, where K5
runs as its plain PyTorch version.

K5's plain version is held to ops/image.py sample_bilinear (the
reference's CPU fetch) and, where a pixel's footprint lies inside its
tile window and its base is not clamped, to the TPU kernel
temporal_pallas.window_sample in interpret mode; the resolve to
ops/taa.py resolve(gather="pixel"); the frames off triangle edges
(bench.py's rule) to the cube_forward_64 golden and to the jitted
reference."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridrenderer_tpu.core.camera import OrbitCamera as RefCamera
from hybridrenderer_tpu.core.config import RenderSettings as RefSettings
from hybridrenderer_tpu.core.types import DisplayMode as RefMode
from hybridrenderer_tpu.core.types import RenderFlags as RefFlags
from hybridrenderer_tpu.core.types import RenderPathType as RefPath
from hybridrenderer_tpu.ops import image as ref_image
from hybridrenderer_tpu.ops import taa as ref_taa
from hybridrenderer_tpu.ops import temporal_pallas
from hybridrenderer_tpu.runtime.renderer import Renderer as RefRenderer
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.core.types import (DisplayMode, RenderFlags,
                                                 RenderPathType)
from hybridrenderer_tpu_torch.graph.params import RS
from hybridrenderer_tpu_torch.ops import taa, temporal_cuda
from hybridrenderer_tpu_torch.runtime.output import read_png, to_u8
from hybridrenderer_tpu_torch.runtime.renderer import Renderer
from hybridrenderer_tpu_torch.scene import scene as port_scenes
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

from .test_torch_slice import CUBE_CAM, _edge_tri_ids
from .torch_parity import clear_reference_knobs, flatten, off_edge_errors

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "cube_forward_64.png")


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    clear_reference_knobs(monkeypatch)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_window_sample_plain_matches_sample_bilinear():
    """K5's plain version against image.sample_bilinear to 1e-6, uv on
    and off the image (clamp-to-edge taps), P = 1, 3 and 4 planes."""
    g = np.random.default_rng(0)
    for P in (1, 3, 4):
        img = g.random((21, 34, P)).astype(np.float32)
        uv = g.uniform(-0.2, 1.2, (17, 29, 2)).astype(np.float32)
        ref = np.asarray(ref_image.sample_bilinear(jnp.asarray(img),
                                                   jnp.asarray(uv)))
        out = temporal_cuda.window_sample(_t(img), _t(uv)).numpy()
        assert out.shape == (17, 29, P)
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_window_sample_matches_pallas_inside_window():
    """K5 against temporal_pallas.window_sample(interpret=True) on the
    pixels whose footprint lies inside their tile window (wsum 1) and
    whose base is not clamped, to 1e-5; the TPU kernel drops the others'
    history, K5 keeps it."""
    g = np.random.default_rng(1)
    H, W = 40, 150
    img = g.random((H, W, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    uv = np.stack([(xx + 0.5) / W, (yy + 0.5) / H], -1)
    shift = np.stack([3.0 * np.sin(yy / 6.0) + 0.4 * g.standard_normal(
        (H, W)), 2.5 * np.cos(xx / 15.0)], -1)
    shift[::7, ::9] -= 20.0                     # leaves its tile window
    uv = (uv - shift / np.array([W, H])).astype(np.float32)
    pix = uv * np.array([W, H], np.float32) - 0.5
    base = np.clip(np.floor(pix), 0.0, np.array([W - 2, H - 2], np.float32))
    f = pix - base
    ok = ((uv >= 0.0) & (uv <= 1.0)).all(-1)
    samples, wsum = temporal_pallas.window_sample(
        jnp.asarray(np.moveaxis(img, -1, 0)),
        jnp.asarray(base[..., 1].astype(np.int32)),
        jnp.asarray(base[..., 0].astype(np.int32)), jnp.asarray(f[..., 1]),
        jnp.asarray(f[..., 0]), jnp.asarray(ok), interpret=True)
    ref = np.moveaxis(np.asarray(samples), 0, -1)
    out = temporal_cuda.window_sample(_t(img), _t(uv)).numpy()
    inside = (np.asarray(wsum) > 0.999) & (np.floor(pix) == base).all(-1)
    assert 0.5 < inside.mean() < 0.99
    np.testing.assert_allclose(out[inside], ref[inside], rtol=0, atol=1e-5)


@pytest.mark.parametrize("history_valid", [True, False])
def test_resolve_matches_reference(history_valid):
    """taa.resolve against the reference's resolve(gather="pixel") on
    random frames (HDR colour with some fireflies, motion, reversed-Z
    depth, jitters), to 1e-5."""
    g = np.random.default_rng(2 + history_valid)
    H, W = 37, 52
    cur = (g.random((H, W, 3)) ** 3 * 4.0).astype(np.float32)
    hist = (g.random((H, W, 3)) * 2.0).astype(np.float32)
    motion = (g.standard_normal((H, W, 2)) * 0.01).astype(np.float32)
    motion[5:9] = 0.3                           # off-screen reprojection
    depth = g.random((H, W)).astype(np.float32)
    jit_ = np.array([0.01, -0.02], np.float32)
    prev_j = np.array([-0.015, 0.005], np.float32)
    ref = np.asarray(ref_taa.resolve(
        jnp.asarray(cur), jnp.asarray(hist), jnp.asarray(motion),
        jnp.asarray(depth), jnp.asarray(jit_), jnp.asarray(prev_j),
        history_valid=history_valid, gather="pixel"))
    out = taa.resolve(_t(cur), _t(hist), _t(motion), _t(depth), _t(jit_),
                      _t(prev_j), history_valid=history_valid).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def _forward_settings(size, flags, **kw):
    return RenderSettings(width=size, height=size,
                          path=RenderPathType.FORWARD, flags=flags, **kw)


def test_forward_matches_golden():
    """tests/goldens/cube_forward_64.png (LIGHT | IBL, no TAA), by the
    port alone: off-edge max 16 u8, p99 2."""
    size = 64
    r = Renderer.for_scene(_forward_settings(size, RenderFlags.LIGHT
                                             | RenderFlags.IBL),
                           port_scenes.cube_scene().build("cpu"))
    img = to_u8(r.render_np(OrbitCamera(width=size, height=size,
                                        **CUBE_CAM).step()))
    tri = _edge_tri_ids(ref_scenes.cube_scene().build(),
                        RefCamera(width=size, height=size, **CUBE_CAM).step(),
                        size)
    off_max, p99 = off_edge_errors(img, read_png(GOLDEN), tri)
    assert off_max <= 16 and p99 <= 2.0, (off_max, p99)


@pytest.mark.parametrize("flags,mode,frames", [
    (RenderFlags.LIGHT | RenderFlags.IBL | RenderFlags.TAA,
     DisplayMode.FINAL, 4),
    (RenderFlags.LIGHT | RenderFlags.SHADOW, DisplayMode.FINAL, 1),
    (RenderFlags.LIGHT | RenderFlags.IBL, DisplayMode.NORMAL, 1),
])
def test_forward_matches_reference(flags, mode, frames):
    """The forward frame against the jitted reference, every frame to
    2 u8 / p99 1 off edges: with TAA over 4 jittered frames (K5 fetches
    the history from frame 2 on), with the inline sun shadow, and a
    display mode."""
    size = 64
    ref_data = ref_scenes.cube_scene().build()
    ref = RefRenderer.for_scene(
        RefSettings(width=size, height=size, path=RefPath.FORWARD,
                    flags=RefFlags(int(flags)), display_mode=RefMode(mode),
                    raster_backend="jnp", trace_backend="jnp"), ref_data)
    port = Renderer.for_scene(_forward_settings(size, flags,
                                                display_mode=mode),
                              scene_from_numpy(flatten(ref_data), "cpu"))
    ref_cam = RefCamera(width=size, height=size, **CUBE_CAM)
    cam = OrbitCamera(width=size, height=size, **CUBE_CAM)
    taa_on = bool(flags & RenderFlags.TAA)
    for frame in range(frames):
        ref_state = ref_cam.step(taa_enabled=taa_on)
        ref_img = to_u8(np.asarray(ref.render(ref_state)))
        img = to_u8(port.render_np(cam.step(taa_enabled=taa_on)))
        ref_cam.orbit(0.02, 0.0)
        cam.orbit(0.02, 0.0)
        off_max, p99 = off_edge_errors(
            img, ref_img, _edge_tri_ids(ref_data, ref_state, size))
        assert off_max <= 2 and p99 <= 1.0, (frame, off_max, p99)
    if taa_on:
        assert port.state.history[RS.TAA_OUTPUT].shape == (size, size, 3)
