"""Port vs reference: the binned tile rasterizer's plain version (K1)
and the G-buffer built from its attribute image.

The port's resolve follows the reference's jnp rasterizer
(ops/raster.py rasterize) arithmetic; its Pallas kernel
(raster_pallas.rasterize_binned) computes the same contract with
pre-folded affine forms. Tri ids agree off triangle edges with both;
values agree with the jnp rasterizer to float rounding and with the
Pallas kernel to its own rounding of the same quantities."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridrenderer_tpu.core.camera import OrbitCamera as RefCamera
from hybridrenderer_tpu.ops import gbuffer as ref_gbuffer
from hybridrenderer_tpu.ops import raster as ref_raster
from hybridrenderer_tpu.ops import raster_pallas
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu_torch.core.camera import CameraState
from hybridrenderer_tpu_torch.ops import gbuffer, raster, raster_cuda
from hybridrenderer_tpu_torch.ops.image import tri_boundary_mask
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

from .torch_parity import clear_reference_knobs, flatten, one_torch_thread

_CAM_FIELDS = ("view", "proj", "view_inverse", "proj_inverse",
               "view_proj_inverse", "prev_view", "prev_proj", "position",
               "jitter", "prev_jitter")


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    clear_reference_knobs(monkeypatch)
    with one_torch_thread():
        yield


def _port_cam(ref_cam):
    return CameraState(**{f: np.asarray(getattr(ref_cam, f))
                          for f in _CAM_FIELDS}).to("cpu")


def _port_raster(data, cam, W, H, cull=False):
    vp = cam.proj @ cam.view
    soup = data.triangles
    corners = torch.stack([raster.transform_to_clip(v, vp)
                           for v in (soup.v0, soup.v1, soup.v2)], dim=1)
    tris = raster.clip_triangles(corners, W, H,
                                 single_sided=soup.single_sided if cull
                                 else None)
    return raster_cuda.rasterize_binned(tris, W, H, data.raster_rows)


def _case(scene_fn, W, H, cam_kw):
    ref_data = scene_fn().build()
    ref_cam = RefCamera(width=W, height=H, **cam_kw).step()
    data = scene_from_numpy(flatten(ref_data), "cpu")
    return ref_data, ref_cam, data, _port_cam(ref_cam)


def test_plain_k1_matches_pallas_kernel():
    """Against raster_pallas.rasterize_binned(interpret=True,
    attr_table=raster_rows), called as tests/test_raster_attrs.py does,
    on the cube scene at 128x32."""
    W, H = 128, 32
    ref_data, ref_cam, data, cam = _case(
        ref_scenes.cube_scene, W, H,
        dict(distance=6.0, pitch=0.5, focal_point=(0, 0.75, 0)))
    clip = ref_raster.transform_to_clip(
        ref_data.vertices.world_position,
        jnp.asarray(ref_cam.proj) @ jnp.asarray(ref_cam.view))
    tris = ref_raster.clip_triangles(clip, ref_data.triangles.i0,
                                     ref_data.triangles.i1,
                                     ref_data.triangles.i2, W, H)
    ref_vis, ref_attrs = raster_pallas.rasterize_binned(
        tris, W, H, interpret=True, attr_table=ref_data.raster_rows)
    vis, attrs = _port_raster(data, cam, W, H)

    ref_tri = np.asarray(ref_vis.tri_id)
    off = ~tri_boundary_mask(ref_tri)
    assert 0.2 < (ref_tri >= 0).mean() < 1.0
    np.testing.assert_array_equal(vis.tri_id.numpy()[off], ref_tri[off])
    m = off & (ref_tri >= 0)
    for name in ("depth", "bary1", "bary2"):
        np.testing.assert_allclose(getattr(vis, name).numpy()[m],
                                   np.asarray(getattr(ref_vis, name))[m],
                                   rtol=0, atol=1e-5, err_msg=name)
    # attributes (world positions up to ~10) interpolated with the two
    # kernels' differently rounded weights: 1e-5 plus 2 ulps of the value
    np.testing.assert_allclose(attrs.numpy()[m], np.asarray(ref_attrs)[m],
                               rtol=2.5e-7, atol=1e-5)
    np.testing.assert_array_equal(attrs.numpy()[ref_tri < 0], 0.0)


# Seen from outside its 60 x 60 floor, so that no triangle crosses the
# near plane. A clipped triangle has screen vertices ~1e6 px away; its
# edge functions then cancel to ~1e-4 relative, and the reference's jit
# (which contracts multiply-adds) and eager arithmetic round apart by
# that much.
STRESS_CAM = dict(distance=90.0, pitch=0.6, yaw=0.8, focal_point=(0, 2, 0))


@pytest.mark.parametrize("cull", [False, True])
def test_plain_k1_matches_jnp_rasterizer(cull):
    """Against ops/raster.rasterize (the reference's CPU path) on the
    stress scene, with and without back-face culling."""
    W, H = 128, 64
    ref_data, ref_cam, data, cam = _case(
        lambda: ref_scenes.stress_scene(num_objects=8, seed=5), W, H,
        STRESS_CAM)
    soup = ref_data.triangles
    ref_vis = ref_raster.rasterize_scene(
        ref_data.vertices.world_position, soup.i0, soup.i1, soup.i2,
        ref_cam, W, H, jitter_enabled=False,
        single_sided=soup.single_sided if cull else None)
    vis, _ = _port_raster(data, cam, W, H, cull=cull)
    ref_tri = np.asarray(ref_vis.tri_id)
    off = ~tri_boundary_mask(ref_tri)
    np.testing.assert_array_equal(vis.tri_id.numpy()[off], ref_tri[off])
    m = off & (ref_tri >= 0)
    for name in ("depth", "bary1", "bary2"):
        np.testing.assert_allclose(getattr(vis, name).numpy()[m],
                                   np.asarray(getattr(ref_vis, name))[m],
                                   rtol=0, atol=1e-5, err_msg=name)


def test_gbuffer_from_kernel_attrs_matches_reference_gather():
    """The port's G-buffer (kernel attribute path) against the
    reference's jnp raster + attr_rows gather G-buffer, at the tolerance
    the reference holds its own two paths to (tests/test_raster_attrs.py)."""
    W, H = 128, 64
    ref_data, ref_cam, data, cam = _case(
        lambda: ref_scenes.stress_scene(num_objects=8, seed=5), W, H,
        STRESS_CAM)
    soup = ref_data.triangles
    ref_vis = ref_raster.rasterize_scene(
        ref_data.vertices.world_position, soup.i0, soup.i1, soup.i2,
        ref_cam, W, H, jitter_enabled=False)
    ref_gb = ref_gbuffer.build_gbuffer(ref_vis, ref_data, ref_cam)
    vis, attrs = _port_raster(data, cam, W, H)
    gb = gbuffer.build_gbuffer(vis, data, cam, attrs)
    off = ~tri_boundary_mask(np.asarray(ref_vis.tri_id))
    np.testing.assert_array_equal(gb.object_id.numpy()[off],
                                  np.asarray(ref_gb.object_id)[off])
    for name in ("albedo", "normal", "material", "motion", "emissive",
                 "world_pos", "uv", "linear_depth", "depth_grad", "depth"):
        a = getattr(gb, name).numpy()[off]
        b = np.asarray(getattr(ref_gb, name))[off]
        np.testing.assert_allclose(a, b, atol=2e-3, err_msg=name)


def test_binning_lists_every_candidate_tile_pair():
    """No cap, no drop: every on-screen candidate appears in every tile
    its bbox touches, once, in ascending candidate order — including a
    triangle that covers the whole screen."""
    g = np.random.default_rng(2)
    W, H = 100, 70
    n = 300
    lo = g.uniform(-20, 110, (n, 2)).astype(np.float32)
    size = g.choice([1.0, 8.0, 40.0, 400.0], size=(n, 1)).astype(np.float32)
    bbox = torch.from_numpy(np.stack(
        [lo[:, 0], lo[:, 0] + size[:, 0], lo[:, 1], lo[:, 1] + size[:, 0]],
        -1))
    valid = torch.from_numpy(g.random(n) < 0.8)
    ts, ec = raster_cuda.bin_candidates(bbox, valid, W, H)
    T = raster_cuda.TILE
    ntx, nty = -(-W // T), -(-H // T)
    assert ts.shape == (ntx * nty + 1,) and ts[-1] == ec.shape[0]
    b = bbox.numpy()
    for t in range(ntx * nty):
        tx, ty = t % ntx, t // ntx
        x0, y0 = tx * T, ty * T
        want = [c for c in range(n) if valid[c]
                and b[c, 1] >= 0 and b[c, 0] < W and b[c, 3] >= 0
                and b[c, 2] < H
                and min(max(np.floor(b[c, 0] / T), 0), ntx - 1) * T <= x0
                and min(max(np.floor(b[c, 1] / T), 0), ntx - 1) * T >= x0
                and min(max(np.floor(b[c, 2] / T), 0), nty - 1) * T <= y0
                and min(max(np.floor(b[c, 3] / T), 0), nty - 1) * T >= y0]
        assert ec[ts[t]:ts[t + 1]].tolist() == want, t
