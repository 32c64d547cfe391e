"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small shapes. Marked ``cuda``; without a CUDA device (and nvcc)
every test skips. Run them on a GPU machine (which needs no JAX:
--noconftest skips tests/conftest.py, the JAX set-up) with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

chip_smoke.py checks the same kernels at the headline's shapes. Every
kernel does the plain version's float operations in the same order
(compiled with -fmad=false), so K1-K3 agree exactly; K4's exp and pow
may differ in the last ulp."""
import numpy as np
import pytest
import torch

from hybridrenderer_tpu_torch import native
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.ops import raster, raster_cuda, stencil_cuda
from hybridrenderer_tpu_torch.ops import temporal_cuda, trace_cuda
from hybridrenderer_tpu_torch.ops.trace import SceneTracer
from hybridrenderer_tpu_torch.scene import scene as scenes

pytestmark = pytest.mark.cuda

CAM = dict(distance=25.0, pitch=0.5, yaw=0.8, focal_point=(0, 2, 0))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def test_raster_kernel_matches_plain(dev):
    W, H = 200, 120
    data = scenes.stress_scene(num_objects=12).build(dev)
    cam = OrbitCamera(width=W, height=H, **CAM).step().to(dev)
    vp = cam.proj @ cam.view
    corners = torch.stack([raster.transform_to_clip(v, vp)
                           for v in (data.triangles.v0, data.triangles.v1,
                                     data.triangles.v2)], dim=1)
    rec, bbox, valid = raster_cuda.pack_candidates(
        raster.clip_triangles(corners, W, H))
    ts, ec = raster_cuda.bin_candidates(bbox, valid, W, H)
    before = native.KERNELS["raster_tiles"].launches
    vk, ak = raster_cuda.raster_tiles(rec, ts, ec, data.raster_rows, W, H)
    assert native.KERNELS["raster_tiles"].launches == before + 1
    vp_, ap = raster_cuda.raster_tiles_plain(rec, ts, ec, data.raster_rows,
                                             W, H)
    torch.testing.assert_close(vk.tri_id, vp_.tri_id, rtol=0, atol=0)
    for a, b in ((vk.depth, vp_.depth), (vk.bary1, vp_.bary1),
                 (vk.bary2, vp_.bary2), (ak, ap)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_trace_kernel_matches_plain(dev):
    tracer = SceneTracer.build(scenes.stress_scene(num_objects=12).build(dev))
    g = np.random.default_rng(0)
    R = 8192
    o = _t(g.uniform([-20, 0.05, -10], [20, 6, 10], (R, 3)).astype(
        np.float32), dev)
    d = g.standard_normal((R, 3)).astype(np.float32)
    d = _t(d / np.linalg.norm(d, axis=-1, keepdims=True), dev)
    tmax = _t(g.choice([10.0, 1e4], R).astype(np.float32), dev)
    active = _t(g.random(R) < 0.9, dev)
    args = (tracer.packed, o, d, 0.01, tmax, active)
    k = trace_cuda.intersect_any(*args)
    p = trace_cuda.intersect_any_plain(*args)
    assert ((k >= 0) != (p >= 0)).float().mean().item() <= 1e-3
    assert (k[~active] == -1).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_temporal_kernel_matches_plain(dev, dtype):
    g = np.random.default_rng(1)
    H, W = 45, 70
    mp = np.zeros((H, W, 4), np.float32)
    mp[..., 0] = 0.01 * g.standard_normal((H, W))
    mp[..., 1] = 0.01 * g.standard_normal((H, W))
    mp[..., 2] = 5.0 + g.random((H, W))
    nrm = g.standard_normal((H, W, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    oid = g.integers(0, 2, (H, W)).astype(np.int32)
    hs = _t(g.random((H, W, 4)).astype(np.float32), dev).to(dtype)
    hm = _t(g.random((H, W, 4)).astype(np.float32), dev).to(dtype)
    args = (hs, hm, _t(nrm, dev), _t(mp[..., 2] * 1.02, dev), _t(oid, dev),
            _t(mp, dev), _t(nrm, dev), _t(oid, dev))
    torch.testing.assert_close(temporal_cuda.temporal_fetch(*args),
                               temporal_cuda.temporal_fetch_plain(*args),
                               rtol=0, atol=0)


def test_stencil_kernels_match_plain(dev):
    g = np.random.default_rng(2)
    H, W = 37, 150
    sig = _t(g.random((H, W, 4)).astype(np.float32), dev)
    mom = _t((g.random((H, W, 4)) * [1, 1, 1, 6]).astype(np.float32), dev)
    mp = g.random((H, W, 4)).astype(np.float32) + 0.5
    mp[2:5, 10:40, 2] = 0.0
    mp = _t(mp, dev)
    nrm = _t(g.random((H, W, 3)).astype(np.float32), dev)
    phi_n = float(np.float32(0.02))
    pairs = [(stencil_cuda.filter_moments(sig, mom, nrm, mp, 4.0, phi_n),
              stencil_cuda.filter_moments_plain(sig, mom, nrm, mp, 4.0,
                                                phi_n)),
             ((stencil_cuda.variance_blur(mom),),
              (stencil_cuda.variance_blur_plain(mom),))]
    for step in (1, 2, 4):
        pairs.append(((stencil_cuda.atrous(sig, nrm, mp, step, 128.0,
                                           phi_n),),
                      (stencil_cuda.atrous_plain(sig, nrm, mp, step, 128.0,
                                                 phi_n),)))
    for ks, ps in pairs:
        for k, p in zip(ks, ps):
            torch.testing.assert_close(k, p, rtol=1e-5, atol=1e-6)


def test_cuda_frame_matches_cpu_frame(dev):
    """The hybrid frame on the card (kernels) against the same frame on
    the CPU (plain versions), off triangle edges."""
    from hybridrenderer_tpu_torch.core.config import RenderSettings
    from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType
    from hybridrenderer_tpu_torch.ops.image import tri_boundary_mask
    from hybridrenderer_tpu_torch.runtime.output import to_u8
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    size = 64
    s = RenderSettings(width=size, height=size, path=RenderPathType.HYBRID,
                       flags=RenderFlags.default_hybrid(), ao_block=8)
    imgs = []
    for d in (torch.device("cpu"), dev):
        r = Renderer.for_scene(s, scenes.cornell_scene().build(d))
        cam = OrbitCamera(width=size, height=size, distance=13.0,
                          focal_point=(0, 2.5, 0))
        for _ in range(3):
            img = r.render(cam.step())
        imgs.append(to_u8(img.cpu().numpy()))
        tri = r.state.history["ObjectID"].cpu().numpy()
    err = np.abs(imgs[0].astype(int) - imgs[1].astype(int)).max(-1)
    assert err[~tri_boundary_mask(tri)].max() <= 16
