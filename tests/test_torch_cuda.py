"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small shapes. Marked ``cuda``; without a CUDA device (and nvcc)
every test skips. Run them on a GPU machine (which needs no JAX:
--noconftest skips tests/conftest.py, the JAX set-up) with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

chip_smoke.py checks the same kernels at the headline's shapes. Every
kernel does the plain version's float operations in the same order
(compiled with -fmad=false), so K1-K3, K1v, K2b, K2w, K2m and K5 agree
exactly; K4's exp and pow may differ in the last ulp."""
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
        r = Renderer.for_scene(s, scene().build(d))
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
            "taa": ("window_sample",)}.get(flags, ("trace_any",))
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
               for k in want + ("window_sample",))
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
