"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small shapes. Marked ``cuda``; without a CUDA device (and nvcc)
every test skips. Run them on a GPU machine (which needs no JAX:
--noconftest skips tests/conftest.py, the JAX set-up) with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

chip_smoke.py checks the same kernels at the headline's shapes. Every
kernel does the plain version's float operations in the same order
(compiled with -fmad=false), so K1-K3, K1v, K2b, K2w, K2m, K5, the
hit-shading pair and the TAA pair agree exactly; K4's exp and pow may
differ in the last ulp."""
import numpy as np
import pytest
import torch

from hybridrenderer_tpu_torch import native
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.ops import raster, raster_cuda, stencil_cuda
from hybridrenderer_tpu_torch.ops import temporal_cuda, trace_cuda
from hybridrenderer_tpu_torch.ops.trace import SceneTracer
from hybridrenderer_tpu_torch.scene import scene as scenes

from . import torch_shade_cases as shade_cases
from . import torch_taa_cases as taa_cases

pytestmark = pytest.mark.cuda

CAM = dict(distance=25.0, pitch=0.5, yaw=0.8, focal_point=(0, 2, 0))
# TAA's launches: the reprojection, the history fetch K5, the resolve
TAA_KERNELS = ("taa_reproject", "window_sample", "taa_resolve")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


# 203x117 cuts tiles in both axes, and some of its tiles list more than
# 256 candidates, so the kernel walks several staged chunks
@pytest.mark.parametrize("W,H", [(200, 120), (203, 117)])
def test_raster_kernel_matches_plain(dev, W, H):
    data = scenes.stress_scene(num_objects=12).build(dev)
    cam = OrbitCamera(width=W, height=H, **CAM).step().to(dev)
    vp = cam.proj @ cam.view
    corners = torch.stack([raster.transform_to_clip(v, vp)
                           for v in (data.triangles.v0, data.triangles.v1,
                                     data.triangles.v2)], dim=1)
    rec, bbox, valid = raster_cuda.pack_candidates(
        raster.clip_triangles(corners, W, H))
    ts, ec = raster_cuda.bin_candidates(bbox, valid, W, H)
    if (W, H) == (203, 117):
        assert int((ts[1:] - ts[:-1]).max()) > 256
    before = native.KERNELS["raster_tiles"].launches
    vk, ak = raster_cuda.raster_tiles(rec, ts, ec, data.raster_rows, W, H)
    assert native.KERNELS["raster_tiles"].launches == before + 1
    vp_, ap = raster_cuda.raster_tiles_plain(rec, ts, ec, data.raster_rows,
                                             W, H)
    torch.testing.assert_close(vk.tri_id, vp_.tri_id, rtol=0, atol=0)
    for a, b in ((vk.depth, vp_.depth), (vk.bary1, vp_.bary1),
                 (vk.bary2, vp_.bary2), (ak, ap)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_vis_only_raster_kernels_match_plain(dev):
    """K1 vis-only (the depth prepass) and K1v, exactly."""
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
    before = native.KERNELS["raster_vis"].launches
    pairs = [(raster_cuda.raster_tiles(rec, ts, ec, None, W, H)[0],
              raster_cuda.raster_tiles_plain(rec, ts, ec, None, W, H)[0]),
             (raster_cuda.raster_tiles(rec, ts, ec, None, W, H,
                                       keyed=True)[0],
              raster_cuda.raster_vis_plain(rec, ts, ec, W, H))]
    assert native.KERNELS["raster_vis"].launches == before + 1
    for vk, vp_ in pairs:
        for a, b in ((vk.tri_id, vp_.tri_id), (vk.depth, vp_.depth),
                     (vk.bary1, vp_.bary1), (vk.bary2, vp_.bary2)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# a 16x16 tile of 2,100 entries (17 groups of K1v), at the headline's
# size and at one whose tiles are cut in both axes
@pytest.mark.parametrize("W,H", [(1920, 1080), (203, 117)])
def test_vis_only_raster_kernels_heavy_tile(dev, W, H):
    """K1v and K1 vis-only exactly, on a synthetic tile of 2,100 entries
    with 2^-19 depth steps inside its 128-entry groups and every group's
    triangles repeated at equal exact depths in the next (tests/
    torch_parity.heavy_tile_bins): K1v's groups resolve in parallel and
    combine by exact depth, the earliest group on a tie."""
    from .torch_parity import heavy_tile_bins

    rec, ts, ec = heavy_tile_bins(W, H, 2100, seed=4, device=dev)
    assert int((ts[1:] - ts[:-1]).max()) == 2100
    before = native.KERNELS["raster_vis"].launches
    k1v = raster_cuda.raster_tiles(rec, ts, ec, None, W, H, keyed=True)[0]
    assert native.KERNELS["raster_vis"].launches == before + 1
    k1 = raster_cuda.raster_tiles(rec, ts, ec, None, W, H)[0]
    pairs = [(k1v, raster_cuda.raster_vis_plain(rec, ts, ec, W, H)),
             (k1, raster_cuda.raster_tiles_plain(rec, ts, ec, None, W,
                                                 H)[0])]
    for vk, vp_ in pairs:
        for a, b in ((vk.tri_id, vp_.tri_id), (vk.depth, vp_.depth),
                     (vk.bary1, vp_.bary1), (vk.bary2, vp_.bary2)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (k1v.tri_id != k1.tri_id).any()


@pytest.mark.parametrize("any_hit", [False, True])
def test_packet_kernel_matches_plain(dev, any_hit):
    """K2b exactly (tri, t, u, v), on random rays with a fifth inactive
    and on primary rays in pixel order, traced in 8x4 tile packets
    (``width``); against the per-ray kernels: the same visibility and
    closest t."""
    from hybridrenderer_tpu_torch.core.config import RenderSettings
    from hybridrenderer_tpu_torch.ops import composition

    data = scenes.stress_scene(num_objects=12).build(dev)
    tracer = SceneTracer.build(data, RenderSettings(trace_backend="pallas"))
    g = np.random.default_rng(5)
    R = 8000
    o = _t(g.uniform([-20, 0.05, -10], [20, 6, 10], (R, 3)).astype(
        np.float32), dev)
    d = g.standard_normal((R, 3)).astype(np.float32)
    d = _t(d / np.linalg.norm(d, axis=-1, keepdims=True), dev)
    tmax = _t(g.choice([10.0, 1e6], R).astype(np.float32), dev)
    active = _t(g.random(R) < 0.8, dev)
    W, H = 96, 64
    cam = OrbitCamera(width=W, height=H, **CAM).step().to(dev)
    po = cam.position.expand(H * W, 3).contiguous()
    pd = composition.view_directions(cam, H, W, dev).reshape(-1, 3)
    for args, width in (((o, d, 0.01, tmax, active), 0),
                        ((po, pd.contiguous(), 0.01,
                          torch.full((H * W,), 1e6, device=dev),
                          torch.ones(H * W, dtype=torch.bool, device=dev)),
                         W)):
        before = native.KERNELS["trace_packet"].launches
        k = trace_cuda.intersect_packet(tracer.packed, *args, any_hit, width)
        assert native.KERNELS["trace_packet"].launches == before + 1
        p = trace_cuda.intersect_packet_plain(tracer.packed, *args, any_hit,
                                              width)
        for a, b in zip(k, p):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        act = args[4]
        assert (k[1][~act] == -1).all()
        per_ray = tracer.packed
        if any_hit:
            ref = trace_cuda.intersect_any(per_ray, *args)
            assert torch.equal(ref >= 0, k[1] >= 0)
        else:
            ref = trace_cuda.intersect_closest(per_ray, *args)
            torch.testing.assert_close(ref[0], k[0], rtol=0, atol=0)


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
    # the same path through the tree: even the triangle reported agrees
    assert torch.equal(k, p)


def test_closest_hit_kernel_matches_plain(dev):
    tracer = SceneTracer.build(scenes.stress_scene(num_objects=12).build(dev))
    g = np.random.default_rng(3)
    R = 8192
    o = _t(g.uniform([-20, 0.05, -10], [20, 6, 10], (R, 3)).astype(
        np.float32), dev)
    d = g.standard_normal((R, 3)).astype(np.float32)
    d = _t(d / np.linalg.norm(d, axis=-1, keepdims=True), dev)
    tmax = _t(g.choice([10.0, 1e6], R).astype(np.float32), dev)
    active = _t(g.random(R) < 0.9, dev)
    args = (tracer.packed, o, d, 0.01, tmax, active)
    before = native.KERNELS["trace_closest"].launches
    tk, trik, uk, vk = trace_cuda.intersect_closest(*args)
    assert native.KERNELS["trace_closest"].launches == before + 1
    tp, trip, up, vp = trace_cuda.intersect_closest_plain(*args)
    assert (trik != trip).float().mean().item() <= 1e-3
    same = trik == trip
    for a, b in ((tk, tp), (uk, up), (vk, vp)):
        torch.testing.assert_close(a[same], b[same], rtol=0, atol=0)
    assert (trik[~active] == -1).all() and torch.isinf(tk[trik < 0]).all()


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("case", ["one_triangle", "chain63", "all_inactive",
                                  "ragged", "ragged_image"])
def test_trace_kernels_edge_cases(dev, case, any_hit):
    """K2 / K2c against their plain versions, exactly (tri, and t, u, v
    for closest-hit): one triangle (the root is a leaf); a chain of depth
    63, whose rays along -x fill the stack to its 63 entries; every ray
    inactive; and a ray count that is a multiple of no block, traced in
    order and as an image 100 pixels wide in 8x4 tiles (its last tile
    column and its last row of pixels partial)."""
    from hybridrenderer_tpu_torch.ops import bvh

    from .torch_parity import chain_bvh

    g = np.random.default_rng(9)
    R = 8192 + 77 if case.startswith("ragged") else 4096
    width = 100 if case == "ragged_image" else 0
    if case == "one_triangle":
        v = tuple(torch.tensor([c], dtype=torch.float32, device=dev) for c in
                  ([-1.0, 0.0, -1.0], [1.0, 0.0, -1.0], [0.0, 0.0, 1.0]))
        packed = trace_cuda.pack_bvh(bvh.build_sah(*v), *v)
        o = g.uniform(-2, 2, (R, 3))
        d = -o + g.uniform(-1.5, 1.5, (R, 3))
    elif case == "chain63":
        tree, *v = chain_bvh(trace_cuda.STACK_DEPTH, dev)
        packed = trace_cuda.pack_bvh(tree, *v)
        assert packed.depth == trace_cuda.STACK_DEPTH - 1
        side = np.arange(R) % 2 == 0
        o = np.stack([np.where(side, 80.0, -20.0), g.uniform(-0.4, 0.4, R),
                      g.uniform(-0.4, 0.4, R)], 1)
        d = np.stack([np.where(side, -1.0, 1.0), g.uniform(-0.01, 0.01, R),
                      g.uniform(-0.01, 0.01, R)], 1)
    else:
        packed = SceneTracer.build(
            scenes.stress_scene(num_objects=12).build(dev)).packed
        o = g.uniform([-20, 0.05, -10], [20, 6, 10], (R, 3))
        d = g.standard_normal((R, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = (_t(x.astype(np.float32), dev) for x in (o, d))
    tmax = _t(g.choice([10.0, 1e6], R).astype(np.float32), dev)
    active = _t(g.random(R) < (0.0 if case == "all_inactive" else 0.9), dev)
    args = (packed, o, d, 0.01, tmax, active)
    name = "trace_any" if any_hit else "trace_closest"
    before = native.KERNELS[name].launches
    if any_hit:
        k = (trace_cuda.intersect_any(*args, width),)
        p = (trace_cuda.intersect_any_plain(*args),)
    else:
        k = trace_cuda.intersect_closest(*args, width)
        p = trace_cuda.intersect_closest_plain(*args)
    assert native.KERNELS[name].launches == before + 1
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    tri = k[-1] if any_hit else k[1]
    assert (tri[~active] == -1).all()
    if case == "all_inactive":
        assert (tri == -1).all()
    else:
        assert (tri >= 0).float().mean().item() > 0.05


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("case", ["one_triangle", "chain95", "all_inactive",
                                  "first_leaf", "ragged", "ragged_image"])
def test_packet_kernel_edge_cases(dev, case, any_hit):
    """K2b against its plain version, exactly (tri, t, u, v): one
    triangle (the root is a leaf); a chain of depth 95, whose rays along
    -x fill the 96-entry stack (all three slots of every lane) to 95
    entries; every ray inactive; packets whose every lane hits the first
    leaf they reach (rays straight down onto the chain's triangles: the
    any-hit warp stops at once); a ray count that is a multiple of no
    block, in order and as an image 203 pixels wide in 8x4 tiles (its
    last tile column and last row of tiles partial)."""
    from hybridrenderer_tpu_torch.ops import bvh

    from .torch_parity import chain_bvh

    g = np.random.default_rng(10)
    R = 8192 + 77 if case.startswith("ragged") else 4096
    width = 203 if case == "ragged_image" else 0
    stack = trace_cuda.PACKET_STACK_DEPTH
    if case == "one_triangle":
        v = tuple(torch.tensor([c], dtype=torch.float32, device=dev) for c in
                  ([-1.0, 0.0, -1.0], [1.0, 0.0, -1.0], [0.0, 0.0, 1.0]))
        packed = trace_cuda.pack_bvh(bvh.build_sah(*v), *v, stack)
        o = g.uniform(-2, 2, (R, 3))
        d = -o + g.uniform(-1.5, 1.5, (R, 3))
    elif case in ("chain95", "first_leaf"):
        tree, *v = chain_bvh(stack, dev)
        packed = trace_cuda.pack_bvh(tree, *v, stack)
        assert packed.depth == stack - 1
        if case == "chain95":
            side = np.arange(R) % 64 < 32
            o = np.stack([np.where(side, 120.0, -20.0),
                          g.uniform(-0.4, 0.4, R), g.uniform(-0.4, 0.4, R)], 1)
            d = np.stack([np.where(side, -1.0, 1.0),
                          g.uniform(-0.01, 0.01, R),
                          g.uniform(-0.01, 0.01, R)], 1)
        else:
            # onto triangle k of the chain (the plane x = k) along -x from
            # just in front of it: each packet's rays hit one triangle
            k = (np.arange(R) // 32) % stack
            o = np.stack([k + 0.3, g.uniform(-0.4, 0.4, R),
                          g.uniform(-0.4, 0.4, R)], 1)
            d = np.stack([-np.ones(R), g.uniform(-0.01, 0.01, R),
                          g.uniform(-0.01, 0.01, R)], 1)
    else:
        packed = SceneTracer.build(
            scenes.stress_scene(num_objects=12).build(dev)).packed
        o = g.uniform([-20, 0.05, -10], [20, 6, 10], (R, 3))
        d = g.standard_normal((R, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = (_t(x.astype(np.float32), dev) for x in (o, d))
    tmax = _t(g.choice([10.0, 1e6], R).astype(np.float32), dev)
    if case == "first_leaf":
        tmax = torch.full((R,), 0.5, device=dev)
    frac = {"all_inactive": 0.0, "first_leaf": 1.0}.get(case, 0.9)
    active = _t(g.random(R) < frac, dev)
    args = (packed, o, d, 0.01, tmax, active, any_hit, width)
    before = native.KERNELS["trace_packet"].launches
    k = trace_cuda.intersect_packet(*args)
    assert native.KERNELS["trace_packet"].launches == before + 1
    p = trace_cuda.intersect_packet_plain(*args)
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    tri = k[1]
    assert (tri[~active] == -1).all()
    if case == "all_inactive":
        assert (tri == -1).all()
    elif case == "first_leaf":
        assert (tri >= 0).all()
    else:
        assert (tri >= 0).float().mean().item() > 0.05


@pytest.mark.parametrize("kernel", ["trace_wide", "trace_mimt"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_wide_kernels_match_plain(dev, kernel, any_hit):
    """K2w and K2m against their plain versions on the card, exact in t,
    tri, u and v: random rays (10% inactive, per-ray tmax, a ragged last
    program) and primary rays in 32x32 tile order; then against the
    per-ray K2 / K2c on the same rays."""
    from hybridrenderer_tpu_torch.core.config import RenderSettings
    from hybridrenderer_tpu_torch.ops import composition
    from hybridrenderer_tpu_torch.ops.trace import tile_major

    data = scenes.stress_scene(num_objects=12).build(dev)
    wide_kernel = "mimt" if kernel == "trace_mimt" else "compressed"
    tracer = SceneTracer.build(data, RenderSettings(
        trace_backend="pallas-wide", wide_kernel=wide_kernel))
    packed = SceneTracer.build(data).packed
    f = getattr(trace_cuda, "intersect_" + kernel[6:])
    plain = getattr(trace_cuda, "intersect_" + kernel[6:] + "_plain")
    g = np.random.default_rng(1)
    R = 5000
    o = _t(g.uniform([-20, 0.05, -10], [20, 6, 10], (R, 3)).astype(
        np.float32), dev)
    d = g.standard_normal((R, 3)).astype(np.float32)
    d = _t(d / np.linalg.norm(d, axis=-1, keepdims=True), dev)
    tmax = _t(g.choice([10.0, 1e6], R).astype(np.float32), dev)
    active = _t(g.random(R) < 0.9, dev)
    W, H = 96, 64
    cam = OrbitCamera(width=W, height=H, **CAM).step().to(dev)
    fwd, _ = tile_major(H, W, dev)
    po = cam.position.expand(fwd.shape[0], 3).contiguous()
    pd = composition.view_directions(cam, H, W, dev).reshape(-1, 3)[fwd]
    for args in ((o, d, 0.01, tmax, active),
                 (po, pd.contiguous(), 0.01,
                  torch.full(fwd.shape, 1e6, device=dev),
                  torch.ones(fwd.shape, dtype=torch.bool, device=dev))):
        before = native.KERNELS[kernel].launches
        k = f(tracer.wide, *args, any_hit)
        assert native.KERNELS[kernel].launches == before + 1
        p = plain(tracer.wide, *args, any_hit)
        for a, b in zip(k, p):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        act = args[4]
        assert (k[1][~act] == trace_cuda.INACTIVE_TRI).all()
        if any_hit:
            ref = trace_cuda.intersect_any(packed, *args)
            assert torch.equal(ref >= 0, (k[1] >= 0) & act)
        else:
            ref = trace_cuda.intersect_closest(packed, *args)
            torch.testing.assert_close(ref[0][act], k[0][act], rtol=0,
                                       atol=0)
    assert int(tracer.wide.deep_pushes.item()) == 0


@pytest.mark.parametrize("case", ["all_inactive", "r1025", "near_wall",
                                  "half_inactive", "one_active"])
@pytest.mark.parametrize("kernel", ["trace_wide", "trace_mimt"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_wide_kernels_edge_cases(dev, kernel, any_hit, case):
    """K2w and K2m against their plain versions where the kernels skip
    tests, exact in t, tri, u and v: every ray inactive; 1,025 rays, a
    program whose second packet is all padding but one ray; a packet of
    rays that all hit the floor right below them beside a packet of
    random rays (any-hit: the finished packet keeps popping beside its
    live sibling, and its later hits decide its triangle ids); half the
    rays inactive (closest-hit: their votes still count); one active ray
    a packet, cast downwards."""
    from hybridrenderer_tpu_torch.core.config import RenderSettings

    data = scenes.stress_scene(num_objects=12).build(dev)
    tracer = SceneTracer.build(data, RenderSettings(
        trace_backend="pallas-wide",
        wide_kernel="mimt" if kernel == "trace_mimt" else "compressed"))
    f = getattr(trace_cuda, "intersect_" + kernel[6:])
    plain = getattr(trace_cuda, "intersect_" + kernel[6:] + "_plain")
    g = np.random.default_rng(11)
    R = {"r1025": 1025, "one_active": 4096}.get(case, 2048)
    o = g.uniform([-20, 0.05, -10], [20, 6, 10], (R, 3))
    d = g.standard_normal((R, 3))
    if case == "near_wall":
        # packet 0: straight down onto the floor from 0.05-0.3 above it
        o[:1024, 1] = g.uniform(0.05, 0.3, 1024)
        d[:1024] = [0.0, -1.0, 0.0] + g.uniform(-0.05, 0.05, (1024, 3))
    elif case == "one_active":
        d[:, 1] = -np.abs(d[:, 1]) - 1.0   # downwards: the floor or above
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = (_t(x.astype(np.float32), dev) for x in (o, d))
    tmax = _t(g.choice([10.0, 1e6], R).astype(np.float32), dev)
    active = {"all_inactive": np.zeros(R, bool),
              "half_inactive": g.random(R) < 0.5,
              "one_active": np.arange(R) % 1024 == 517}.get(
        case, g.random(R) < 0.9)
    active = _t(active, dev)
    args = (o, d, 0.01, tmax, active, any_hit)
    before = native.KERNELS[kernel].launches
    k = f(tracer.wide, *args)
    assert native.KERNELS[kernel].launches == before + 1
    p = plain(tracer.wide, *args)
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (k[1][~active] == trace_cuda.INACTIVE_TRI).all()
    assert (k[0][~active] == -1.0).all()
    hit = (k[1] >= 0) & active
    if case == "all_inactive":
        assert not hit.any()
    elif case == "near_wall":
        assert hit[:1024][active[:1024]].all() and hit[1024:].any()
    else:
        assert hit.any()
    assert int(tracer.wide.deep_pushes.item()) == 0


def test_window_sample_kernel_matches_plain(dev):
    g = np.random.default_rng(4)
    img = _t(g.random((45, 70, 3)).astype(np.float32), dev)
    uv = _t(g.uniform(-0.1, 1.1, (45, 70, 2)).astype(np.float32), dev)
    before = native.KERNELS["window_sample"].launches
    k = temporal_cuda.window_sample(img, uv)
    assert native.KERNELS["window_sample"].launches == before + 1
    torch.testing.assert_close(k, temporal_cuda.window_sample_plain(img, uv),
                               rtol=0, atol=0)


def _unaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary."""
    base = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = base[1:].view(t.shape)
    view.copy_(t)
    return view


def _window_sample_case(case, g):
    """(image (H, W, P), uv (..., 2)) as numpy f32 for one K5 case; uv
    from pixel centres moved a little, as TAA's reprojection moves them,
    unless the case says otherwise."""
    H, W, P, rows = 45, 70, 3, None
    if case.startswith("p"):
        P = int(case[1:])
    elif case == "ragged_203x117":
        H, W = 117, 203
    elif case == "shard":
        H, W, rows = 48, 64, (12, 24)
    elif case == "unaligned_image":
        P = 4
    r0, r1 = rows or (0, H)
    yy, xx = np.mgrid[r0:r1, 0:W].astype(np.float32)
    uv = np.stack([(xx + 0.5) / W, (yy + 0.5) / H], -1)
    uv = uv + 0.004 * g.standard_normal(uv.shape)
    if case == "offscreen":
        uv = np.where(g.random(uv.shape) < 0.5,
                      g.uniform(-3.0, -0.01, uv.shape),
                      g.uniform(1.01, 4.0, uv.shape))
    elif case == "zero_one":
        uv = g.choice([0.0, 1.0], uv.shape)
    elif case == "far":
        uv = g.random(uv.shape)
    return (g.random((H, W, P)).astype(np.float32), uv.astype(np.float32))


@pytest.mark.parametrize("case", [
    "p1", "p3", "p4", "ragged_203x117", "offscreen", "zero_one", "far",
    "shard", "unaligned_uv", "unaligned_image"])
def test_window_sample_kernel_cases(dev, case):
    """K5 equal to its plain version bit for bit, one launch a call: P =
    1, 3, 4; a width and a point count (203x117) that neither a lane's
    points nor a warp's divide; uv wholly off screen; uv exactly 0 and 1;
    footprints far from their own pixels; the shard shape (12 uv rows over
    a 48-row image); a uv view and a 4-plane image view that are not
    16-byte aligned."""
    img, uv = (_t(a, dev) for a in _window_sample_case(
        case, np.random.default_rng(5)))
    if case == "unaligned_uv":
        uv = _unaligned(uv)
    elif case == "unaligned_image":
        img = _unaligned(img)
    before = native.KERNELS["window_sample"].launches
    k = temporal_cuda.window_sample(img, uv)
    assert native.KERNELS["window_sample"].launches == before + 1
    assert k.shape == (*uv.shape[:-1], img.shape[-1])
    torch.testing.assert_close(k, temporal_cuda.window_sample_plain(img, uv),
                               rtol=0, atol=0)


def test_window_sample_empty_image_raises(dev):
    """An image without pixels has no taps: K5 refuses it unlaunched."""
    before = native.KERNELS["window_sample"].launches
    with pytest.raises(ValueError, match="empty image"):
        temporal_cuda.window_sample(torch.zeros((0, 4, 3), device=dev),
                                    torch.zeros((5, 2), device=dev))
    assert native.KERNELS["window_sample"].launches == before


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


# 5x7 is smaller than atrous' halo at step 4 (8 pixels) and barely
# wider than filter_moments' 7x7 stencil; 117x203 is not a multiple of
# the kernels' tiles
@pytest.mark.parametrize("H,W", [(37, 150), (5, 7), (117, 203)])
def test_stencil_kernels_match_plain(dev, H, W):
    g = np.random.default_rng(2)
    sig = _t(g.random((H, W, 4)).astype(np.float32), dev)
    mom = _t((g.random((H, W, 4)) * [1, 1, 1, 6]).astype(np.float32), dev)
    mp = g.random((H, W, 4)).astype(np.float32) + 0.5
    mp[2:5, 10:40, 2] = 0.0
    mp[0, :3, 2] = 2000.0    # beyond atrous' background depth
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


CORNELL_KW = dict(distance=13.0, focal_point=(0, 2.5, 0))
CUBE_KW = dict(distance=7.0, pitch=0.45, yaw=0.6, focal_point=(0, 0.7, 0))
# the share of pixels off edges whose reflection or GI ray may hit another
# triangle on the card than on the CPU (the last-ulp differences of the
# G-buffer glue move a grazing ray's origin)
SECONDARY_FLIP_MAX = 2e-3


@pytest.mark.parametrize("path,flags,cam_kw,max_off,max_p99", [
    # readings on an H100 (off-edge max / p99): 0 / 0, 0 / 0, 1 / 0, 1 / 0
    ("HYBRID", "default", CORNELL_KW, 4, 2.0),
    ("HYBRID", "full_raw", CORNELL_KW, 2, 1.0),
    ("HYBRID", "full", CORNELL_KW, 5, 2.0),
    ("FORWARD", "taa", CUBE_KW, 5, 2.0),
])
def test_cuda_frame_matches_cpu_frame(dev, path, flags, cam_kw, max_off,
                                      max_p99):
    """A frame on the card (kernels) against the same frame on the CPU
    (plain versions), 3 frames at 64x64, off edges (object boundaries,
    and for the full graph the pixels whose reflection or GI ray hit
    another triangle on the two devices): the hybrid frame, the full
    graph with SVGF off (no chaos: every shading term held tight) and
    on, on cornell; forward + TAA on the cube. The SVGF chains can
    amplify last-ulp differences, as between the reference's own jit and
    eager renders (tests/test_torch_full_graph.py), so each gate but
    the SVGF-off one stands at the card-vs-CPU reading plus 4 / 2, as
    the reference's gates do; the SVGF-off frame is held to 2 / 1."""
    from hybridrenderer_tpu_torch.core.config import RenderSettings
    from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType
    from hybridrenderer_tpu_torch.ops.image import tri_boundary_mask
    from hybridrenderer_tpu_torch.runtime.output import to_u8
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    from .torch_parity import record_secondary_hits

    size = 64
    full = RenderFlags.default_hybrid() | RenderFlags.REFLECTION \
        | RenderFlags.GI
    f = {"default": RenderFlags.default_hybrid(),
         "full": full,
         "full_raw": full & ~(RenderFlags.SVGF | RenderFlags.SVGF_TEMPORAL
                              | RenderFlags.SVGF_SPATIAL),
         "taa": RenderFlags.LIGHT | RenderFlags.IBL | RenderFlags.TAA}[flags]
    s = RenderSettings(width=size, height=size, path=RenderPathType[path],
                       flags=f, ao_block=8, gi_block=8)
    scene = scenes.cornell_scene if path == "HYBRID" else scenes.cube_scene
    imgs, hits = [], []
    for d in (torch.device("cpu"), dev):
        native.reset_counts()
        # eager frames: the hit recorder reads each query on the host
        r = Renderer.for_scene(s, scene().build(d), capture=False)
        take = record_secondary_hits(r) if r.tracer is not None else list
        cam = OrbitCamera(width=size, height=size, **cam_kw)
        for _ in range(3):
            take()
            img = r.render(cam.step(taa_enabled=flags == "taa"))
        imgs.append(to_u8(img.cpu().numpy()))
        hits.append(take())
        tri = r.state.history["ObjectID"].cpu().numpy()
    assert not any(k.plain_cuda_calls for k in native.KERNELS.values())
    want = {"full": ("trace_closest",), "full_raw": ("trace_closest",),
            "taa": TAA_KERNELS}.get(flags, ("trace_any",))
    assert all(native.KERNELS[k].launches > 0 for k in want)
    edges = tri_boundary_mask(tri)
    flips = np.zeros_like(edges)
    for mine, theirs in zip(*hits):
        flips |= (mine != theirs) & ~edges
    diff = np.abs(imgs[0].astype(int) - imgs[1].astype(int))
    off_max = int(diff.max(-1)[~(edges | flips)].max())
    p99 = float(np.percentile(diff, 99))
    print(f"card vs CPU, {path} {flags}: off-edge max {off_max} u8, p99 "
          f"{p99}, secondary flips {int(flips.sum())} px")
    assert flips.mean() <= SECONDARY_FLIP_MAX
    assert off_max <= max_off and p99 <= max_p99, (off_max, p99)


@pytest.mark.parametrize("mode,max_off,max_p99", [
    # readings on an H100 (off-edge max / p99): 1 / 1, 1 / 1
    ("default", 2, 1.0),
    ("packet", 2, 1.0),
])
def test_cuda_raytraced_frame_matches_cpu_frame(dev, mode, max_off, max_p99):
    """The ray-traced path (depth prepass, primary rays, TAA) on the card
    against the CPU, 3 frames at 64x64 on the cube, off the edges of a
    K1 raster of the unjittered camera: with the default kernels (K1
    vis-only, K2c + K2, K5) and with raster_eval "v2" and trace_backend
    "pallas" (K1v, K2b, K5). No SVGF, so the frame is held to the
    reference's TAA gate, 2 / 1."""
    from hybridrenderer_tpu_torch.core.config import RenderSettings
    from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType
    from hybridrenderer_tpu_torch.ops.image import tri_boundary_mask
    from hybridrenderer_tpu_torch.runtime.output import to_u8
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    size = 64
    kw = dict(raster_eval="v2", trace_backend="pallas") \
        if mode == "packet" else {}
    s = RenderSettings(width=size, height=size,
                       path=RenderPathType.RAYTRACED,
                       flags=RenderFlags.LIGHT | RenderFlags.IBL
                       | RenderFlags.EMISSIVE | RenderFlags.TAA, **kw)
    imgs = []
    for d in (torch.device("cpu"), dev):
        native.reset_counts()
        r = Renderer.for_scene(s, scenes.cube_scene().build(d))
        cam = OrbitCamera(width=size, height=size, **CUBE_KW)
        for _ in range(3):
            img = r.render(cam.step(taa_enabled=True))
            cam.orbit(0.02, 0.0)
        imgs.append(to_u8(img.cpu().numpy()))
    assert not any(k.plain_cuda_calls for k in native.KERNELS.values())
    want = ("raster_vis", "trace_packet") if mode == "packet" \
        else ("raster_tiles", "trace_closest", "trace_any")
    assert all(native.KERNELS[k].launches > 0
               for k in want + TAA_KERNELS)
    data = scenes.cube_scene().build("cpu")
    cam = OrbitCamera(width=size, height=size, **CUBE_KW).step().to("cpu")
    vp = cam.proj @ cam.view
    corners = torch.stack([raster.transform_to_clip(v, vp)
                           for v in (data.triangles.v0, data.triangles.v1,
                                     data.triangles.v2)], dim=1)
    vis, _ = raster_cuda.rasterize_binned(
        raster.clip_triangles(corners, size, size), size, size, None)
    edges = tri_boundary_mask(vis.tri_id.numpy())
    diff = np.abs(imgs[0].astype(int) - imgs[1].astype(int))
    off_max = int(diff.max(-1)[~edges].max())
    p99 = float(np.percentile(diff, 99))
    print(f"card vs CPU, ray-traced {mode}: off-edge max {off_max} u8, p99 "
          f"{p99}")
    assert off_max <= max_off and p99 <= max_p99, (off_max, p99)


@pytest.mark.parametrize("kernel,svgf,max_off,max_p99", [
    # readings on an H100 (off-edge max / p99): SVGF on 18 / 3 for both
    # kernels (the cube's SVGF chaos: the reference's own jit and eager
    # renders differ by 20 / 6), SVGF off 0 / 0 for both
    ("compressed", True, 22, 5.0),
    ("mimt", True, 22, 5.0),
    ("compressed", False, 2, 1.0),
    ("mimt", False, 2, 1.0),
])
def test_cuda_dynamic_frame_matches_cpu_frame(dev, kernel, svgf, max_off,
                                              max_p99):
    """The dynamic hybrid frame (entity 1 of the cube moving before each
    of 3 frames, DynamicScene.commit: transform update, refit of the
    8-wide tree, K2w or K2m) on the card against the CPU, 64x64, off the
    last frame's object edges. With SVGF at the reading plus 4 / 2, as
    the other SVGF frames' gates; without it at the reference's 2 / 1."""
    from hybridrenderer_tpu_torch.core.config import RenderSettings
    from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType
    from hybridrenderer_tpu_torch.ops.image import tri_boundary_mask
    from hybridrenderer_tpu_torch.runtime.output import to_u8
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer
    from hybridrenderer_tpu_torch.scene.dynamic import DynamicScene

    size = 64
    flags = RenderFlags.default_hybrid()
    if not svgf:
        flags &= ~(RenderFlags.SVGF | RenderFlags.SVGF_TEMPORAL
                   | RenderFlags.SVGF_SPATIAL)
    s = RenderSettings(width=size, height=size, path=RenderPathType.HYBRID,
                       flags=flags, ao_block=8, gi_block=8,
                       trace_backend="pallas-wide", wide_kernel=kernel)
    imgs = []
    for d in (torch.device("cpu"), dev):
        native.reset_counts()
        host = scenes.cube_scene()
        r = Renderer.for_scene(s, host.build(d))
        dyn = DynamicScene(host, r)
        cam = OrbitCamera(width=size, height=size, **CUBE_KW)
        for i in range(3):
            t = np.eye(4, dtype=np.float32)
            t[:3, 3] = [0.3 * i, 0.75, 0.1 * i]
            dyn.set_entity_transform(1, t)
            dyn.commit()
            img = r.render(cam.step())
        imgs.append(to_u8(img.cpu().numpy()))
        tri = r.state.history["ObjectID"].cpu().numpy()
    assert not any(k.plain_cuda_calls for k in native.KERNELS.values())
    name = "trace_mimt" if kernel == "mimt" else "trace_wide"
    assert native.KERNELS[name].launches > 0
    assert native.KERNELS["trace_any"].launches == 0
    edges = tri_boundary_mask(tri)
    diff = np.abs(imgs[0].astype(int) - imgs[1].astype(int))
    off_max = int(diff.max(-1)[~edges].max())
    p99 = float(np.percentile(diff, 99))
    print(f"card vs CPU, dynamic {kernel}, SVGF {svgf}: off-edge max "
          f"{off_max} u8, p99 {p99}")
    assert off_max <= max_off and p99 <= max_p99, (off_max, p99)


STRESS_KW = dict(distance=18.0, pitch=0.5, yaw=0.8, focal_point=(0, 2.0, 0))
CUTOUT_KW = dict(distance=9.0, pitch=0.35, yaw=0.4, focal_point=(0, 1.2, 0))


def test_sampler_on_card_matches_cpu(dev):
    """The bilinear sampler's gathers and lerps on the card against the
    CPU on the same stack (two sizes, one padded) and UVs, ids -1 too;
    elementwise kernels may contract a multiply-add on the card, so to
    1e-6."""
    from hybridrenderer_tpu_torch.ops import texture

    g = np.random.default_rng(0)
    data = g.random((2, 64, 64, 4)).astype(np.float32)
    sizes = np.array([[64, 64], [32, 16]], np.int32)
    uv = g.uniform(-2.5, 3.5, (1 << 16, 2)).astype(np.float32)
    tid = g.choice(np.array([-1, 0, 1], np.int32), 1 << 16)
    out = [texture.sample_bilinear(_t(data, d), _t(sizes, d), _t(tid, d),
                                   _t(uv, d), (0.0, 0.5, 1.0, 1.0)).cpu()
           for d in (torch.device("cpu"), dev)]
    print(f"sampler card vs CPU: max abs {(out[0] - out[1]).abs().max()}")
    torch.testing.assert_close(out[1], out[0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("scene,svgf,max_off,max_p99", [
    # readings on an H100 (off-edge max / p99): SVGF on 1 / 0 and 0 / 0,
    # SVGF off 0 / 0 and 0 / 0
    ("stress_textured", True, 5, 2.0),
    ("cutout", True, 4, 2.0),
    ("stress_textured", False, 2, 1.0),
    ("cutout", False, 2, 1.0),
])
def test_cuda_textured_frame_matches_cpu_frame(dev, scene, svgf, max_off,
                                               max_p99):
    """Textured and cut-out hybrid frames on the card against the CPU, 3
    frames at 64x64, off the last frame's object edges: the stress scene
    with its four colour textures (24 objects), and the cut-out scene
    (K1 twice a frame, the opaque and the cut-out layer; the shadow and
    AO rays' alpha rounds through K2c). With SVGF at the card-vs-CPU
    reading plus 4 / 2, as the other SVGF frames' gates; without it at
    the reference's 2 / 1."""
    from hybridrenderer_tpu_torch.core.config import RenderSettings
    from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType
    from hybridrenderer_tpu_torch.ops.image import tri_boundary_mask
    from hybridrenderer_tpu_torch.runtime.output import to_u8
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    size = 64
    flags = RenderFlags.default_hybrid()
    if not svgf:
        flags &= ~(RenderFlags.SVGF | RenderFlags.SVGF_TEMPORAL
                   | RenderFlags.SVGF_SPATIAL)
    s = RenderSettings(width=size, height=size, path=RenderPathType.HYBRID,
                       flags=flags, ao_block=8, gi_block=8)
    make, cam_kw = {
        "stress_textured": (lambda: scenes.stress_scene(
            num_objects=24, textured=True), STRESS_KW),
        "cutout": (scenes.cutout_scene, CUTOUT_KW)}[scene]
    imgs, counts = [], {}
    for d in (torch.device("cpu"), dev):
        native.reset_counts()
        r = Renderer.for_scene(s, make().build(d))
        cam = OrbitCamera(width=size, height=size, **cam_kw)
        for _ in range(3):
            img = r.render(cam.step())
        imgs.append(to_u8(img.cpu().numpy()))
        tri = r.state.history["ObjectID"].cpu().numpy()
        counts = {k.name: k.launches for k in native.KERNELS.values()}
    assert not any(k.plain_cuda_calls for k in native.KERNELS.values())
    if scene == "cutout":
        # two layers a frame; every shadow and AO ray in closest-hit rounds
        assert counts["raster_tiles"] == 6 and counts["trace_any"] == 0
        assert counts["trace_closest"] == 3 * 2 * 4
    else:
        assert counts["raster_tiles"] == 3 and counts["trace_any"] > 0
    edges = tri_boundary_mask(tri)
    diff = np.abs(imgs[0].astype(int) - imgs[1].astype(int))
    off_max = int(diff.max(-1)[~edges].max())
    p99 = float(np.percentile(diff, 99))
    print(f"card vs CPU, {scene}, SVGF {svgf}: off-edge max {off_max} u8, "
          f"p99 {p99}")
    assert off_max <= max_off and p99 <= max_p99, (off_max, p99)


# --- the captured frame ------------------------------------------------------

def _capture_case(case):
    """(settings, host scene factory, camera, taa, dynamic) of a case."""
    from hybridrenderer_tpu_torch.core.config import RenderSettings
    from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType

    hyb = RenderFlags.default_hybrid()
    rt = RenderFlags.LIGHT | RenderFlags.IBL | RenderFlags.EMISSIVE \
        | RenderFlags.TAA
    path, flags, scene, cam, taa = {
        "hybrid": ("HYBRID", hyb, scenes.cornell_scene, CORNELL_KW, False),
        "full_graph": ("HYBRID", hyb | RenderFlags.REFLECTION
                       | RenderFlags.GI, scenes.cornell_scene, CORNELL_KW,
                       False),
        "forward_taa": ("FORWARD", RenderFlags.LIGHT | RenderFlags.IBL
                        | RenderFlags.TAA, scenes.cube_scene, CUBE_KW, True),
        "raytraced": ("RAYTRACED", rt, scenes.cube_scene, CUBE_KW, True),
        "dynamic": ("HYBRID", hyb, scenes.cube_scene, CUBE_KW, False),
        "cutout": ("HYBRID", hyb, scenes.cutout_scene, CUTOUT_KW, False),
    }[case]
    s = RenderSettings(width=64, height=64, path=RenderPathType[path],
                       flags=flags, ao_block=8, gi_block=8)
    return s, scene, cam, taa, case == "dynamic"


def _render_frames(dev, case, capture, frames=4, trace=False):
    """``frames`` frames of a case on the card → (images, launches a
    kernel made, the renderer); the dynamic case moves entity 1 before
    each frame through DynamicScene.commit_and_render."""
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer
    from hybridrenderer_tpu_torch.scene.dynamic import DynamicScene

    s, scene, cam_kw, taa, dynamic = _capture_case(case)
    host = scene()
    r = Renderer.for_scene(s, host.build(dev), capture=capture, trace=trace)
    dyn = DynamicScene(host, r) if dynamic else None
    cam = OrbitCamera(width=64, height=64, **cam_kw)
    native.reset_counts()
    imgs = []
    for i in range(frames):
        cs = cam.step(taa_enabled=taa)
        if dyn is not None:
            t = np.eye(4, dtype=np.float32)
            t[:3, 3] = [0.3 * i, 0.75, 0.1 * i]
            dyn.set_entity_transform(1, t)
            imgs.append(dyn.commit_and_render(cs))
        else:
            imgs.append(r.render(cs))
        cam.orbit(0.02, 0.0)
    counts = {k.name: (k.launches, k.plain_cuda_calls)
              for k in native.KERNELS.values()}
    return imgs, counts, r


@pytest.mark.parametrize("case", ["hybrid", "full_graph", "forward_taa",
                                  "raytraced", "dynamic", "cutout"])
def test_captured_frame_equals_eager_frame(dev, case):
    """Four frames through the captured renderer (frames 1 and 2 run
    eagerly and capture their keys' graphs; 3 and 4 replay) against the
    same frames run eagerly (``capture=False``): equal bit for bit, and
    the same kernel launches, counted over the replays."""
    captured, counts_c, r = _render_frames(dev, case, True)
    eager, counts_e, _ = _render_frames(dev, case, False)
    assert sorted(k[0] for k in r._graphs) == (
        ["dynamic", "dynamic"] if case == "dynamic" else ["frame", "frame"])
    for i, (a, b) in enumerate(zip(captured, eager)):
        assert torch.equal(a, b), (case, i)
    assert counts_c == counts_e
    assert not any(plain for _, plain in counts_c.values())
    if _capture_case(case)[3]:
        assert all(counts_c[k] == (4, 0) for k in TAA_KERNELS), counts_c


def test_captured_burst_and_restore(dev, tmp_path):
    """render_burst of 4 hybrid frames equals 4 captured render() calls,
    history included; a checkpoint after 2 frames restored into a
    captured renderer that has run (and captured) other frames resumes
    the same frames 3 and 4."""
    from hybridrenderer_tpu_torch.runtime import state_io
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    s, scene, cam_kw, _, _ = _capture_case("hybrid")
    data = scene().build(dev)

    def cams(n, yaw=0.0):
        cam = OrbitCamera(width=64, height=64, **cam_kw)
        cam.orbit(yaw, 0.0)
        return [cam.step() for _ in range(n)]

    seq = Renderer.for_scene(s, data)
    frames = [seq.render(c) for c in cams(2)]
    ck = str(tmp_path / "state.npz")
    state_io.save_renderer(ck, seq)
    frames += [seq.render(c) for c in cams(4)[2:]]
    bur = Renderer.for_scene(s, data)
    burst = bur.render_burst(cams(4))
    assert all(torch.equal(burst[i], frames[i]) for i in range(4))
    for k, v in seq.state.history.items():
        assert torch.equal(bur.state.history[k], v), k
    other = Renderer.for_scene(s, data)
    for c in cams(3, yaw=0.5):
        other.render(c)
    state_io.restore_renderer(ck, other)
    resumed = [other.render(c) for c in cams(4)[2:]]
    assert torch.equal(resumed[0], frames[2])
    assert torch.equal(resumed[1], frames[3])


def test_binning_overflow_raises(dev):
    """A captured frame whose rasters need more tile entries than a fixed
    binning capacity raises before its commit: no image, the history and
    the frame count as they were. With the capacity no longer fixed, the
    same view then renders (its key captured again at a capacity sized
    from what it needed) and equals the eager frame bit for bit."""
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    s, scene, cam_kw, _, _ = _capture_case("hybrid")
    data = scene().build(dev)
    r = Renderer.for_scene(s, data)
    eager = Renderer.for_scene(s, data, capture=False)
    r.bin_capacity = 16
    cam = OrbitCamera(width=64, height=64, **cam_kw)
    states = [cam.step() for _ in range(3)]
    for cs in states[:2]:     # the eager first frames bin exactly
        r.render(cs)
        eager.render(cs)
    before = {k: v.clone() for k, v in r.state.history.items()}
    with pytest.raises(RuntimeError, match="binning capacity"):
        r.render(states[2])
    assert r.frame_count == 2
    assert all(torch.equal(before[k], v) for k, v in r.state.history.items())
    r.bin_capacity = None
    assert torch.equal(r.render(states[2]), eager.render(states[2]))
    assert r._graphs[("frame", True)].capacity[0] > 16
    for k, v in eager.state.history.items():
        assert torch.equal(r.state.history[k], v), k


def test_binning_overflow_recaptures(dev, monkeypatch):
    """With the per-key capacity (the default), a view that needs more
    tile entries than its key's graph holds is captured again at a larger
    capacity and rendered, not dropped: the cube scene at 64x64 with the
    slack set to 0, frames 1-2 far (12 entries, capacity 24), frames 3-4
    near (48 entries): every frame equals the eager frame bit for bit."""
    from hybridrenderer_tpu_torch.runtime import renderer as renderer_mod

    monkeypatch.setattr(renderer_mod, "BIN_SLACK", 0)
    s, scene, cam_kw, _, _ = _capture_case("dynamic")
    data = scene().build(dev)
    far = OrbitCamera(width=64, height=64, distance=60.0, pitch=0.0,
                      yaw=0.0, focal_point=(0, 2.5, 0))
    near = OrbitCamera(width=64, height=64, **cam_kw)
    states = [far.step(), far.step(), near.step(), near.step()]
    imgs = []
    for capture in (True, False):
        r = renderer_mod.Renderer.for_scene(s, data, capture=capture)
        imgs.append([r.render(cs) for cs in states])
        if capture:
            assert r._graphs[("frame", True)].capacity == (2 * 48,)
    for i, (a, b) in enumerate(zip(*imgs)):
        assert torch.equal(a, b), i


@pytest.mark.parametrize("case", ["hybrid", "full_graph", "dynamic"])
def test_traced_frames_equal_untraced(dev, case):
    """Four captured frames of a renderer made with ``trace=True`` (their
    graphs hold the device spans' event nodes) against an untraced
    renderer's, whose graphs hold none: equal bit for bit, with the same
    launches; each replay read every pass's span once."""
    traced, counts_t, r = _render_frames(dev, case, True, trace=True)
    plain, counts_p, rp = _render_frames(dev, case, True)
    for i, (a, b) in enumerate(zip(traced, plain)):
        assert torch.equal(a, b), (case, i)
    assert counts_t == counts_p
    assert all(g.spans == ((), ()) for g in rp._graphs.values())
    assert all(g.spans[0] and g.spans[1] for g in r._graphs.values())
    tot = r.trace_totals()
    assert tot["clock"] == "device"
    names = [p.name for p in r.path.graph.passes] + ["frame", "commit"]
    if case == "dynamic":
        names = ["scene.update", "scene.refit"] + names
    assert list(tot["device"]) == names
    # frames 1-2 eager, 3-4 replayed: four of each span
    assert all(n == 4 and ms > 0.0 for ms, n in tot["device"].values())
    assert {k: n for k, (_, n) in tot["host"].items()} == {
        "upload": 4, "replay": 2, "tile_read": 2,
        "commit": 2, "out_clone": 2, **({"dynamic_pending": 4}
                                         if case == "dynamic" else {})}


def test_device_spans_sum_to_the_replayed_frame(dev):
    """The device spans of a replayed hybrid frame (the passes, the
    frame's glue outside them, the commit) add up to within 2% of CUDA
    events around its frame and commit graphs launched back to back,
    over 10 replays of the 250-object stress scene at 1280x720."""
    from hybridrenderer_tpu_torch.core.config import RenderSettings
    from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    s = RenderSettings(width=1280, height=720, path=RenderPathType.HYBRID,
                       flags=RenderFlags.default_hybrid())
    r = Renderer.for_scene(s, scenes.stress_scene(num_objects=250).build(dev),
                           trace=True)
    cam = OrbitCamera(width=1280, height=720, **CAM)
    for _ in range(3):
        r.render(cam.step())
    g = r._graphs[("frame", True)]
    torch.cuda.synchronize()
    r.reset_trace()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    outer = 0.0
    for _ in range(10):
        start.record()
        g.replay()
        g.commit()
        end.record()
        end.synchronize()
        outer += start.elapsed_time(end)
        r.tracing.replayed(g.spans[0] + g.spans[1])
        r.tracing.flush()
    spans = {k: ms for k, (ms, _) in r.trace_totals()["device"].items()}
    passes = sum(spans[p.name] for p in r.path.graph.passes)
    outside = spans["frame"] - passes
    total = passes + outside + spans["commit"]
    print(f"device spans {total:.3f} ms (passes {passes:.3f}, outside "
          f"{outside:.3f}, commit {spans['commit']:.3f}) against "
          f"{outer:.3f} ms around 10 replays")
    assert outside >= 0.0 and abs(total - outer) <= 0.02 * outer


def test_traced_binning_overflow_counts_one_recapture(dev, monkeypatch):
    """A traced renderer whose view outgrows its key's binning capacity
    (test_binning_overflow_recaptures's frames) counts one recapture, in
    ``recaptures`` and in the host span of that name, whose replay and
    tile read nest under it on the profiler's timeline; its frames equal
    an untraced renderer's."""
    from torch.profiler import ProfilerActivity, profile

    from hybridrenderer_tpu_torch.runtime import profiling
    from hybridrenderer_tpu_torch.runtime import renderer as renderer_mod

    monkeypatch.setattr(renderer_mod, "BIN_SLACK", 0)
    s, scene, cam_kw, _, _ = _capture_case("dynamic")
    data = scene().build(dev)
    far = OrbitCamera(width=64, height=64, distance=60.0, pitch=0.0,
                      yaw=0.0, focal_point=(0, 2.5, 0))
    near = OrbitCamera(width=64, height=64, **cam_kw)
    states = [far.step(), far.step(), near.step(), near.step()]
    r = renderer_mod.Renderer.for_scene(s, data, trace=True)
    plain = renderer_mod.Renderer.for_scene(s, data)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for cs in states:
            assert torch.equal(r.render(cs), plain.render(cs))
    tot = r.trace_totals()
    assert r.recaptures == plain.recaptures == tot["recaptures"] == 1
    assert tot["host"]["recapture"][1] == 1
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.name.startswith(profiling.PREFIX)),
                   key=lambda sp: sp[1])
    (_, r0, r1), = [sp for sp in spans if sp[0] == "hr.recapture"]
    assert [n for n, s0, s1 in spans if r0 <= s0 and s1 <= r1
            and n != "hr.recapture"] == ["hr.replay", "hr.tile_read"]
    # frames 1-2 eager, 3 replayed twice (overflow, then recaptured), 4
    assert tot["device"]["frame"][1] == 5 and tot["device"]["commit"][1] == 4


def test_cuda_display_shadow_matches_cpu(dev):
    """The SHADOW display golden's scene, camera and two frames (cube,
    hybrid flags, 128x128) with SVGF off, the raw 1-spp shadow and AO
    signal, on the card against the CPU, off edges: at most 4 pixels
    more than 2 u8 apart (one ray's hit or miss a pixel can flip on an
    ulp), p99 1. With SVGF on the two read 32 / 3 (the chaos of
    test_torch_display_goldens.py), so that frame is no tight witness."""
    from hybridrenderer_tpu_torch.core.config import RenderSettings
    from hybridrenderer_tpu_torch.core.types import (DisplayMode, RenderFlags,
                                                     RenderPathType)
    from hybridrenderer_tpu_torch.ops.image import tri_boundary_mask
    from hybridrenderer_tpu_torch.runtime.output import to_u8
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    size = 128
    s = RenderSettings(width=size, height=size, path=RenderPathType.HYBRID,
                       flags=RenderFlags.default_hybrid() & ~(
                           RenderFlags.SVGF | RenderFlags.SVGF_TEMPORAL
                           | RenderFlags.SVGF_SPATIAL),
                       display_mode=DisplayMode.SHADOW, ao_block=8,
                       gi_block=8)
    imgs = []
    for d in (torch.device("cpu"), dev):
        r = Renderer.for_scene(s, scenes.cube_scene().build(d))
        cam = OrbitCamera(width=size, height=size, **CUBE_KW)
        for _ in range(2):
            img = r.render(cam.step())
        imgs.append(to_u8(img.cpu().numpy()))
        tri = r.state.history["ObjectID"].cpu().numpy()
    edges = tri_boundary_mask(tri)
    diff = np.abs(imgs[0].astype(int) - imgs[1].astype(int))
    flips = int((diff.max(-1)[~edges] > 2).sum())
    p99 = float(np.percentile(diff, 99))
    print(f"card vs CPU, SHADOW signal: {flips} pixels more than 2 u8 "
          f"apart off edges, p99 {p99}")
    assert imgs[0].std() > 0 and flips <= 4 and p99 <= 1.0, (flips, p99)


def test_capture_failure_raises(dev):
    """A frame that reads a device value on the host cannot be captured:
    the renderer raises after its eager first use and never renders it
    eagerly instead."""
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    s, scene, cam_kw, _, _ = _capture_case("forward_taa")
    r = Renderer.for_scene(s, scene().build(dev))
    post = r.path.graph.passes[-1]
    fn = post.fn

    def syncing(reg, ctx):
        out = fn(reg, ctx)
        float(out["RENDER_OUTPUT"].sum())    # a host sync
        return out

    post.fn = syncing
    cam = OrbitCamera(width=64, height=64, **cam_kw)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        r.render(cam.step(taa_enabled=True))
    assert not r._graphs


@pytest.mark.parametrize("W,H", [(200, 120), (203, 117)])
def test_raster_bf16_kernel_matches_plain(dev, W, H):
    """K1's bf16 mode (raster_attr_bits=16) against its plain version,
    the f32 raster rounded to nearest bf16: every output bit for bit."""
    data = scenes.stress_scene(num_objects=12).build(dev)
    cam = OrbitCamera(width=W, height=H, **CAM).step().to(dev)
    vp = cam.proj @ cam.view
    corners = torch.stack([raster.transform_to_clip(v, vp)
                           for v in (data.triangles.v0, data.triangles.v1,
                                     data.triangles.v2)], dim=1)
    rec, bbox, valid = raster_cuda.pack_candidates(
        raster.clip_triangles(corners, W, H))
    ts, ec = raster_cuda.bin_candidates(bbox, valid, W, H)
    before = native.KERNELS["raster_tiles_bf16"].launches
    vk, ak = raster_cuda.raster_tiles(rec, ts, ec, data.raster_rows, W, H,
                                      attr_bits=16)
    assert native.KERNELS["raster_tiles_bf16"].launches == before + 1
    vp_, ap = raster_cuda.raster_tiles_bf16_plain(rec, ts, ec,
                                                  data.raster_rows, W, H)
    assert ak.dtype == ap.dtype == torch.bfloat16
    assert torch.equal(ak.view(torch.int16), ap.view(torch.int16))
    for a, b in ((vk.tri_id, vp_.tri_id), (vk.depth, vp_.depth),
                 (vk.bary1, vp_.bary1), (vk.bary2, vp_.bary2)):
        assert torch.equal(a, b)


def test_quantized_trace_kernels_match_plain(dev, monkeypatch):
    """K2 and K2c over a quantized scene's records (the budget
    monkeypatched below the wide records, trace_backend "pallas-wide",
    wide_kernel "mimt", which the reference demotes to its direct kernel
    over bf16 records): every triangle, t, u and v equal to the plain
    versions', also after a dynamic update moved an entity and the
    tracer refit."""
    from hybridrenderer_tpu_torch.core.config import RenderSettings
    from hybridrenderer_tpu_torch.ops import trace
    from hybridrenderer_tpu_torch.scene import dynamic

    monkeypatch.setattr(trace, "VMEM_SCENE_BUDGET", 600_000)
    host = scenes.stress_scene(num_objects=40)
    data = host.build(dev)
    tracer = SceneTracer.build(data, RenderSettings(
        trace_backend="pallas-wide", wide_kernel="mimt"))
    assert tracer.quantized and tracer.wide_kernel is None
    maps = dynamic.build_maps(host, dev)
    tf = np.stack([r[1] for r in host._built["rows"]]).astype(np.float32)
    tf[maps.instance_entity.cpu().numpy() == 3, :3, 3] += [0.5, 0.2, -0.4]
    moved = dynamic.update_transforms(data, maps, _t(tf, dev))
    g = np.random.default_rng(5)
    R = 8192
    o = _t(g.uniform([-20, 0.05, -10], [20, 6, 10], (R, 3)).astype(
        np.float32), dev)
    d = g.standard_normal((R, 3)).astype(np.float32)
    d = _t(d / np.linalg.norm(d, axis=-1, keepdims=True), dev)
    tmax = _t(g.choice([10.0, 1e6], R).astype(np.float32), dev)
    active = _t(g.random(R) < 0.9, dev)
    for t in (tracer, tracer.refit(moved)):
        args = (t.packed, o, d, 0.01, tmax, active)
        assert torch.equal(trace_cuda.intersect_any(*args),
                           trace_cuda.intersect_any_plain(*args))
        k = trace_cuda.intersect_closest(*args)
        p = trace_cuda.intersect_closest_plain(*args)
        for a, b in zip(k, p):
            assert torch.equal(a, b)


def test_captured_quantized_full_graph_equals_eager(dev):
    """The full graph on cornell at 64x64 shading its radiance hits from
    the forced quantized table: four captured frames (two replayed) equal
    the eager frames bit for bit, with the same launches."""
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer
    from hybridrenderer_tpu_torch.scene import schema

    s, scene, cam_kw, taa, _ = _capture_case("full_graph")
    imgs, counts = [], []
    for capture in (True, False):
        data = scene().build(dev)
        data.shade_rows_q = schema.build_shade_rows_q(
            data.vertices, data.instances, data.triangles)
        data.inst_shade = schema.build_inst_shade(data.instances,
                                                  data.materials)
        r = Renderer.for_scene(s, data, capture=capture)
        cam = OrbitCamera(width=64, height=64, **cam_kw)
        native.reset_counts()
        frames = []
        for _ in range(4):
            frames.append(r.render(cam.step(taa_enabled=taa)))
            cam.orbit(0.02, 0.0)
        imgs.append(frames)
        counts.append(native.counts())
    for a, b in zip(*imgs):
        assert torch.equal(a, b)
    assert counts[0] == counts[1]


def _stress_candidates(dev, W, H):
    data = scenes.stress_scene(num_objects=12).build(dev)
    cam = OrbitCamera(width=W, height=H, **CAM).step().to(dev)
    vp = cam.proj @ cam.view
    corners = torch.stack([raster.transform_to_clip(v, vp)
                           for v in (data.triangles.v0, data.triangles.v1,
                                     data.triangles.v2)], dim=1)
    return data, raster_cuda.pack_candidates(raster.clip_triangles(corners,
                                                                   W, H))


def test_raster_window_kernels_match_plain(dev):
    """K1 (f32 attributes), K1 vis-only and K1v over 30-row windows of a
    200x120 image, which cut its 16-row bands: each exactly its plain
    version, and the whole image's rows."""
    W, H, h = 200, 120, 30
    data, (rec, bbox, valid) = _stress_candidates(dev, W, H)
    ts, ec = raster_cuda.bin_candidates(bbox, valid, W, H)
    for attr, keyed in ((data.raster_rows, False), (None, False),
                        (None, True)):
        whole, _ = raster_cuda.raster_tiles(rec, ts, ec, attr, W, H,
                                            keyed=keyed)
        wa = None if attr is None else raster_cuda.raster_tiles(
            rec, ts, ec, attr, W, H)[1]
        for row0 in range(0, H, h):
            tw, ew = raster_cuda.bin_candidates(bbox, valid, W, h, row0, H)
            vk, ak = raster_cuda.raster_tiles(rec, tw, ew, attr, W, h,
                                              keyed=keyed, row0=row0)
            if keyed:
                vp_, ap = raster_cuda.raster_vis_plain(
                    rec, tw, ew, W, h, row0=row0), None
            else:
                vp_, ap = raster_cuda.raster_tiles_plain(
                    rec, tw, ew, attr, W, h, row0=row0)
            rows = slice(row0, row0 + h)
            for f in ("tri_id", "depth", "bary1", "bary2"):
                a = getattr(vk, f)
                assert torch.equal(a, getattr(vp_, f)), (f, row0, keyed)
                assert torch.equal(a, getattr(whole, f)[rows]), (f, row0)
            if attr is not None:
                assert torch.equal(ak, ap) and torch.equal(ak, wa[rows])


def test_temporal_window_kernel_matches_plain(dev):
    """K3 over rows 15..29 of a 45x70 frame, reading the whole history:
    exactly its plain version and the whole image's rows."""
    g = np.random.default_rng(2)
    H, W = 45, 70
    mp = np.zeros((H, W, 4), np.float32)
    mp[..., 0] = 0.01 * g.standard_normal((H, W))
    mp[..., 1] = 0.05 * g.standard_normal((H, W))
    mp[..., 2] = 5.0 + g.random((H, W))
    nrm = g.standard_normal((H, W, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    oid = g.integers(0, 2, (H, W)).astype(np.int32)
    hist = (_t(g.random((H, W, 4)).astype(np.float32), dev),
            _t(g.random((H, W, 4)).astype(np.float32), dev), _t(nrm, dev),
            _t(mp[..., 2] * 1.02, dev), _t(oid, dev))
    cur = (_t(mp, dev), _t(nrm, dev), _t(oid, dev))
    whole = temporal_cuda.temporal_fetch(*hist, *cur)
    rows = slice(15, 30)
    win = tuple(x[rows].contiguous() for x in cur)
    k = temporal_cuda.temporal_fetch(*hist, *win, 15)
    torch.testing.assert_close(
        k, temporal_cuda.temporal_fetch_plain(*hist, *win, 15), rtol=0,
        atol=0)
    assert torch.equal(k, whole[rows])


@pytest.mark.parametrize("leaf_tris", [8, 16])
@pytest.mark.parametrize("any_hit", [False, True])
def test_wide_leaf_clusters_match_plain(dev, leaf_tris, any_hit):
    """K2w over 8- and 16-triangle clusters (bvh_leaf_tris) exactly
    against its plain version (t, tri, u, v) on random rays, and against
    the per-ray K2 / K2c: visibility, closest t."""
    from hybridrenderer_tpu_torch.core.config import RenderSettings

    data = scenes.stress_scene(num_objects=12).build(dev)
    tracer = SceneTracer.build(data, RenderSettings(
        trace_backend="pallas-wide", wide_kernel="compressed",
        bvh_leaf_tris=leaf_tris))
    assert tracer.wide_kernel == "compressed"
    assert tracer.wide.leaf_tris == leaf_tris
    packed = SceneTracer.build(data).packed
    g = np.random.default_rng(3)
    R = 5000
    o = _t(g.uniform([-20, 0.05, -10], [20, 6, 10], (R, 3)).astype(
        np.float32), dev)
    d = g.standard_normal((R, 3)).astype(np.float32)
    d = _t(d / np.linalg.norm(d, axis=-1, keepdims=True), dev)
    args = (o, d, 0.01, _t(g.choice([10.0, 1e6], R).astype(np.float32), dev),
            _t(g.random(R) < 0.9, dev))
    before = native.KERNELS["trace_wide"].launches
    k = trace_cuda.intersect_wide(tracer.wide, *args, any_hit)
    assert native.KERNELS["trace_wide"].launches == before + 1
    p = trace_cuda.intersect_wide_plain(tracer.wide, *args, any_hit)
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    act = args[4]
    if any_hit:
        ref = trace_cuda.intersect_any(packed, *args)
        assert torch.equal(ref >= 0, (k[1] >= 0) & act)
    else:
        ref = trace_cuda.intersect_closest(packed, *args)
        torch.testing.assert_close(ref[0][act], k[0][act], rtol=0, atol=0)


@pytest.mark.parametrize("case", ["hybrid", "raytraced", "full_graph"])
def test_sharded_frame_on_one_card(dev, case, capsys):
    """4 shards of 16 rows on the one card against the single-device
    eager frame, 2 frames, within the reference's 2e-4 (reading printed;
    -s shows it); every shard launches its kernels and no plain version
    runs on the card."""
    from hybridrenderer_tpu_torch.core.config import RenderSettings
    from hybridrenderer_tpu_torch.core.types import (RenderFlags,
                                                     RenderPathType)
    from hybridrenderer_tpu_torch.parallel.mesh import make_mesh
    from hybridrenderer_tpu_torch.parallel.sharded import ShardedRenderer
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    flags = {"hybrid": RenderFlags.default_hybrid(),
             "raytraced": RenderFlags.LIGHT | RenderFlags.IBL
             | RenderFlags.EMISSIVE | RenderFlags.TAA,
             "full_graph": RenderFlags.default_hybrid()
             | RenderFlags.REFLECTION | RenderFlags.GI}[case]
    path = RenderPathType.RAYTRACED if case == "raytraced" \
        else RenderPathType.HYBRID
    s = RenderSettings(width=64, height=64, path=path, flags=flags)
    data = scenes.cornell_scene().build(dev)
    cam_kw = dict(distance=7.0, pitch=0.3)
    single = Renderer.for_scene(s, data, capture=False)
    sharded = ShardedRenderer.for_scene(s, data, make_mesh(devices=[dev] * 4))
    frames = []
    for r in (single, sharded):
        cam = OrbitCamera(width=64, height=64, **cam_kw)
        native.reset_counts()
        frames.append([r.render(cam.step(True)) for _ in range(2)])
    counts = native.counts()
    assert not any(plain for _, plain in counts.values())
    assert counts["raster_tiles"][0] == 4 * 2
    diffs = [(a - b).abs().max().item() for a, b in zip(*frames)]
    with capsys.disabled():
        print(f"\n[sharded {case}] 4 shards on one card vs one device: "
              f"max abs diff {diffs}")
    assert max(diffs) <= 2e-4


def test_fused_shadow_frame_on_card(dev):
    """fuse_shadow_ao: two hybrid frames equal the unfused ones bit for
    bit, with one K2 launch a frame instead of two."""
    from hybridrenderer_tpu_torch.core.config import RenderSettings
    from hybridrenderer_tpu_torch.core.types import (RenderFlags,
                                                     RenderPathType)
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    data = scenes.stress_scene(num_objects=12).build(dev)
    out, launches = {}, {}
    for fuse in (False, True):
        r = Renderer.for_scene(RenderSettings(
            width=96, height=64, path=RenderPathType.HYBRID,
            flags=RenderFlags.default_hybrid(), fuse_shadow_ao=fuse), data,
            capture=False)
        cam = OrbitCamera(width=96, height=64, **CAM)
        native.reset_counts()
        out[fuse] = [r.render(cam.step(True)) for _ in range(2)]
        launches[fuse] = native.KERNELS["trace_any"].launches
    assert all(torch.equal(a, b) for a, b in zip(out[False], out[True]))
    assert (launches[False], launches[True]) == (4, 2)


# --- the captured sharded frame ----------------------------------------------

def _sharded_frames(dev, case, make, frames=4, cams=None):
    """``frames`` frames of a _capture_case case through ``make(settings,
    data)``'s renderer (or the camera states ``cams``) → (images, launch
    counts, the renderer)."""
    s, scene, cam_kw, taa, _ = _capture_case(case)
    r = make(s, scene().build(dev))
    if cams is None:
        cam = OrbitCamera(width=64, height=64, **cam_kw)
        cams = []
        for _ in range(frames):
            cams.append(cam.step(taa_enabled=taa))
            cam.orbit(0.02, 0.0)
    native.reset_counts()
    imgs = [r.render(cs) for cs in cams]
    return imgs, native.counts(), r


def _sharded(dev, n=4, **kw):
    from hybridrenderer_tpu_torch.parallel.mesh import make_mesh
    from hybridrenderer_tpu_torch.parallel.sharded import ShardedRenderer

    mesh = make_mesh(devices=[dev] * n)
    return lambda s, data: ShardedRenderer.for_scene(s, data, mesh, **kw)


def _single(s, data):
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    return Renderer.for_scene(s, data)


@pytest.mark.parametrize("case,shard_rays", [
    ("hybrid", True), ("hybrid", False), ("full_graph", True),
    ("full_graph", False), ("forward_taa", True), ("raytraced", True),
    ("raytraced", False)])
def test_captured_sharded_frame_equals_eager(dev, case, shard_rays):
    """H, F, T and R at 64x64 on 4 shards of the one card, and with
    shard_rays off: four frames through the captured sharded renderer
    (frames 1 and 2 run eagerly and capture their keys' graphs, 3 and 4
    replay) equal the eager sharded frames (capture=False) and the
    single-device frames bit for bit, with the same kernel launches as
    the eager sharded frames, counted over the replays."""
    captured, counts_c, r = _sharded_frames(
        dev, case, _sharded(dev, shard_rays=shard_rays))
    eager, counts_e, _ = _sharded_frames(
        dev, case, _sharded(dev, shard_rays=shard_rays, capture=False))
    single, _, _ = _sharded_frames(dev, case, _single)
    assert sorted(r._graphs) == [("frame", False), ("frame", True)]
    for i, (a, b, c) in enumerate(zip(captured, eager, single)):
        assert torch.equal(a, b), (case, i)
        assert torch.equal(a, c), (case, i, (a - c).abs().max().item())
    assert counts_c == counts_e
    assert not any(plain for _, plain in counts_c.values())


def test_sharded_binning_overflow_recaptures(dev, monkeypatch):
    """The cube at 64x64 on 4 shards with the slack set to 1: frames 1-2
    far, 3-4 near, so the shards the cube now covers need more tile
    entries than their capacities: the key is captured again, each shard
    that overflowed at a larger capacity and the others at theirs, and
    every frame equals the eager sharded frame bit for bit."""
    from hybridrenderer_tpu_torch.runtime import renderer as renderer_mod

    monkeypatch.setattr(renderer_mod, "BIN_SLACK", 1)
    s, scene, cam_kw, _, _ = _capture_case("dynamic")
    far = OrbitCamera(width=64, height=64, distance=60.0, pitch=0.0,
                      yaw=0.0, focal_point=(0, 2.5, 0))
    near = OrbitCamera(width=64, height=64, **cam_kw)
    cams = [far.step(), far.step(), near.step(), near.step()]
    r = _sharded(dev)(s, scene().build(dev))
    captured = [r.render(cs) for cs in cams[:2]]
    before = r._graphs[("frame", True)].capacity
    captured += [r.render(cs) for cs in cams[2:]]
    after = r._graphs[("frame", True)].capacity
    eager, _, _ = _sharded_frames(dev, "dynamic", _sharded(dev,
                                                           capture=False),
                                  cams=cams)
    for i, (a, b) in enumerate(zip(captured, eager)):
        assert torch.equal(a, b), i
    assert any(x > y for x, y in zip(after, before)), (before, after)
    assert all(x >= y for x, y in zip(after, before)), (before, after)


def test_sharded_fixed_capacity_raises(dev):
    """A fixed binning capacity too small for the sharded frame raises at
    the first replay, before its commit: the frame count and every
    shard's history as they were. With the capacity no longer fixed the
    same view renders, equal to the eager sharded frame."""
    s, scene, cam_kw, _, _ = _capture_case("hybrid")
    data = scene().build(dev)
    r = _sharded(dev)(s, data)
    eager = _sharded(dev, capture=False)(s, data)
    r.bin_capacity = 16
    cam = OrbitCamera(width=64, height=64, **cam_kw)
    states = [cam.step() for _ in range(3)]
    for cs in states[:2]:
        r.render(cs)
        eager.render(cs)
    before = [{k: v.clone() for k, v in h.items()} for h in r.histories]
    with pytest.raises(RuntimeError, match="binning capacity"):
        r.render(states[2])
    assert r.frame_count == 2
    for h, b in zip(r.histories, before):
        assert h.keys() == b.keys()
        assert all(torch.equal(b[k], v) for k, v in h.items())
    r.bin_capacity = None
    assert torch.equal(r.render(states[2]), eager.render(states[2]))


def test_sharded_capture_failure_raises(dev):
    """A sharded frame that reads a device value on the host cannot be
    captured: the renderer raises after the key's eager first use, with
    no graph and no history kept, and never renders it eagerly
    instead."""
    s, scene, cam_kw, _, _ = _capture_case("forward_taa")
    r = _sharded(dev)(s, scene().build(dev))
    post = r.path.graph.passes[-1]
    fn = post.fn

    def syncing(reg, ctx):
        out = fn(reg, ctx)
        float(out["RENDER_OUTPUT"].sum())    # a host sync
        return out

    post.fn = syncing
    cam = OrbitCamera(width=64, height=64, **cam_kw)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        r.render(cam.step(taa_enabled=True))
    assert not r._graphs and r.frame_count == 0
    assert all(h == {} for h in r.histories)


def test_sharded_frame_over_separate_cards(dev):
    """make_mesh() over the visible cards (one shard a card, as many as
    divide 64 rows): H and R, four frames each through the captured
    sharded renderer, equal the single-device frames bit for bit. Skips
    with fewer than two cards."""
    from hybridrenderer_tpu_torch.parallel.mesh import make_mesh
    from hybridrenderer_tpu_torch.parallel.sharded import ShardedRenderer

    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two or more CUDA devices")
    mesh = make_mesh(max(k for k in range(2, count + 1) if 64 % k == 0))
    assert len(mesh.distinct) == len(mesh)
    for case in ("hybrid", "raytraced"):
        sharded, _, r = _sharded_frames(
            dev, case, lambda s, data: ShardedRenderer.for_scene(s, data,
                                                                 mesh))
        single, _, _ = _sharded_frames(dev, case, _single)
        assert len(r._graphs) == 2
        for i, (a, b) in enumerate(zip(sharded, single)):
            assert a.device == dev and torch.equal(a, b), (case, i)


# --- radiance hit shading: hr_shade_hit and hr_shade_finish ------------------

def _assert_same(k, p, what):
    """``k`` equal to ``p`` bit for bit (NaN where NaN), else the count of
    values that differ and their largest distance in ulps."""
    if k.dtype == torch.bool or torch.equal(k, p):
        assert torch.equal(k, p), what
        return
    same = (k == p) | (torch.isnan(k) & torch.isnan(p))
    ulps = (k.view(torch.int32).long() - p.view(torch.int32).long()).abs()
    assert same.all(), (f"{what}: {int((~same).sum())} of {k.numel()} "
                        f"values differ, by up to {int(ulps.max())} ulps")


@pytest.mark.parametrize("case", sorted(shade_cases.CASES))
def test_shade_kernels_match_plain(dev, case):
    """hr_shade_hit and hr_shade_finish against their plain versions on
    the card, on each case's hits (tests/torch_shade_cases.py: quantized
    rows, four texture slots and the normal map, NEE in a row window, an
    equirect sky, IBL off, LIGHT off, a tile-order tracer, a cut-out
    scene; inactive rays and misses in each): every output bit for bit.
    trace_radiance then launches each kernel once and no plain version,
    and returns what the plain stages compose."""
    from hybridrenderer_tpu_torch.ops import shade_cuda

    tracer, data, ctx, o, d, a, row0 = shade_cases.build(case, dev)
    h = tracer.radiance_hits(o, d, a)
    args = (tracer.shade_rows, data, h.o, h.d, h.t, h.tri, h.u, h.v, h.hit,
            ctx, h.fwd, row0 * h.lead[1])
    k = shade_cuda.shade_hit_prepare(*args)
    p = shade_cuda.shade_hit_prepare_plain(*args)
    assert (k.sun, k.nee) == (p.sun, p.nee)
    for name in ("occ_o", "occ_d", "occ_act", "terms"):
        _assert_same(getattr(k, name), getattr(p, name), name)
    R = h.o.shape[0]
    vis = tracer.occluded(p.occ_o, p.occ_d, shade_cuda.SHADOW_TMAX,
                          p.occ_act, h.width)
    fargs = (data, ctx, p.terms, vis[:R] if p.sun else None,
             vis[-R:] if p.nee else None, h.hit, h.t, h.d, h.pos)
    fk = shade_cuda.shade_hit_finish(*fargs)
    fp = shade_cuda.shade_hit_finish_plain(*fargs)
    for name, x, y in zip(("rgb", "dist"), fk, fp):
        _assert_same(x, y, name)
    native.reset_counts()
    rgb, dist = tracer.trace_radiance(data, o, d, ctx, 0, active=a,
                                      row0=row0)
    counts = native.counts()
    assert counts["shade_hit"] == (1, 0) and counts["shade_finish"] == (1, 0)
    assert not any(plain for _, plain in counts.values())
    _assert_same(rgb.reshape(-1, 3), fp[0], "trace_radiance rgb")
    _assert_same(dist.reshape(-1), fp[1], "trace_radiance distance")


def test_replayed_full_graph_frame_launches_the_shading_pair(dev):
    """A replayed full-graph frame shades its reflection and GI hits with
    one hr_shade_hit and one hr_shade_finish each, and runs no plain
    version."""
    _, _, r = _render_frames(dev, "full_graph", True, frames=3)
    _, _, cam_kw, _, _ = _capture_case("full_graph")
    native.reset_counts()
    r.render(OrbitCamera(width=64, height=64, **cam_kw).step())
    counts = native.counts()
    assert counts["shade_hit"] == (2, 0) and counts["shade_finish"] == (2, 0)
    assert not any(plain for _, plain in counts.values())


# --- TAA's resolve: hr_taa_reproject and hr_taa_resolve around K5 -----------

@pytest.mark.parametrize("case", sorted(taa_cases.CASES))
def test_taa_kernels_match_plain(dev, case):
    """hr_taa_reproject and hr_taa_resolve against their plain versions
    on the card, on each case of tests/torch_taa_cases.py (the whole
    image, a row window with one halo row, no valid history, reprojection
    off every edge, non-finite and negative colour, a strided motion
    slice, a size that cuts the tiles): every output bit for bit. The
    resolve then launches each kernel and K5 once and no plain version,
    and returns the unsplit resolve's image bit for bit."""
    from hybridrenderer_tpu_torch.ops import taa, taa_cuda

    args, kw = taa_cases.build(case, dev)
    cur, hist, motion, depth, jitter, prev_j = args
    rargs = (motion, depth, jitter, prev_j, kw["history_valid"], kw["row0"],
             hist.shape[0])
    k_uv, k_alpha = taa_cuda.taa_reproject(*rargs)
    p_uv, p_alpha = taa_cuda.taa_reproject_plain(*rargs)
    _assert_same(k_uv, p_uv, "prev_uv")
    _assert_same(k_alpha, p_alpha, "alpha")
    sample = temporal_cuda.window_sample(hist, p_uv)
    k = taa_cuda.taa_resolve(cur, sample, p_alpha)
    p = taa_cuda.taa_resolve_plain(cur, sample, p_alpha)
    _assert_same(k, p, "resolved")
    native.reset_counts()
    out = taa.resolve(*args, **kw)
    counts = native.counts()
    assert all(counts[n] == (1, 0) for n in TAA_KERNELS), counts
    assert not any(plain for _, plain in counts.values())
    _assert_same(out, p, "resolve")
    _assert_same(out, taa_cases.unsplit_resolve(*args, **kw), "unsplit")


def test_replayed_forward_taa_frame_launches_the_taa_kernels(dev):
    """A replayed forward + TAA frame resolves with one hr_taa_reproject,
    one K5 fetch and one hr_taa_resolve, and runs no plain version."""
    _, _, r = _render_frames(dev, "forward_taa", True, frames=3)
    _, _, cam_kw, _, _ = _capture_case("forward_taa")
    native.reset_counts()
    r.render(OrbitCamera(width=64, height=64, **cam_kw).step(
        taa_enabled=True))
    counts = native.counts()
    assert all(counts[n] == (1, 0) for n in TAA_KERNELS), counts
    assert not any(plain for _, plain in counts.values())
