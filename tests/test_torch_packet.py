"""Port vs reference: the packet traversal K2b (trace_backend="pallas"),
whose plain version (ops/trace_cuda.py intersect_packet_plain) is held
to the reference's Pallas kernel trace_pallas.intersect_packed in
interpret mode, on the same SAH tree (build_packed over
build_bvh_host), the same rays in the same order.

The two traverse different packets (the TPU's 8x128 rays, the port's
warps of 32), so they visit nodes in different orders: visibility and
closest t agree exactly, and a closest-hit triangle may differ only
between two triangles hit at the same t."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridrenderer_tpu.ops import bvh as ref_bvh
from hybridrenderer_tpu.ops import trace_pallas
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.core.types import RenderFlags
from hybridrenderer_tpu_torch.graph.params import FrameParams
from hybridrenderer_tpu_torch.ops import composition, trace_cuda
from hybridrenderer_tpu_torch.ops.trace import SceneTracer
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

from .test_torch_packet_records import tile_order
from .test_torch_trace import _rays
from .torch_parity import clear_reference_knobs, flatten, one_torch_thread

SCENES = {"cube": (ref_scenes.cube_scene,
                   dict(distance=7.0, pitch=0.45, yaw=0.6,
                        focal_point=(0, 0.7, 0))),
          "cornell": (ref_scenes.cornell_scene,
                      dict(distance=13.0, focal_point=(0, 2.5, 0)))}


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    clear_reference_knobs(monkeypatch)
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def scenes():
    """name → (reference packed tiles, triangle count, port tracer)."""
    out = {}
    for name, (fn, _) in SCENES.items():
        ref_data = fn().build()
        soup = ref_data.triangles
        tree = ref_bvh.build_bvh_host(soup.v0, soup.v1, soup.v2, "sah")
        tiles = trace_pallas.build_packed(tree, soup.v0, soup.v1, soup.v2)
        tracer = SceneTracer.build(
            scene_from_numpy(flatten(ref_data), "cpu"),
            RenderSettings(trace_backend="pallas"))
        out[name] = (tiles, soup.count, tracer)
    return out


def _primary_rays(name, size=32):
    """The camera's primary rays at size x size, in 8x4 tile order."""
    cam = OrbitCamera(width=size, height=size, **SCENES[name][1]).step() \
        .to("cpu")
    perm = tile_order(size, size)
    d = composition.view_directions(cam, size, size, "cpu").reshape(-1, 3)
    o = cam.position.expand(size * size, 3)
    return o.numpy().copy(), d[perm].numpy().copy()


def _on_edge(u, v):
    """Whether a hit's barycentrics put it on its triangle's edge."""
    return np.minimum(np.minimum(u, v), 1.0 - u - v) <= 1e-6


@pytest.mark.parametrize("name,kind", [("cube", "random"),
                                       ("cube", "primary"),
                                       ("cornell", "random"),
                                       ("cornell", "primary")])
def test_packet_plain_matches_pallas_kernel(scenes, name, kind):
    """Hit / miss exact in both modes, closest-hit t to 1e-5 relative,
    every triangle mismatch an equal-t tie (both triangles' t
    recomputed), u and v to 1e-5 where the triangles agree; all but for
    rays through the shared edge of two triangles (a hit with a
    barycentric within 1e-6 of 0 on either side), where the two sides'
    roundings disagree. Reading: no such ray among the random rays and
    the cube's; 11 of cornell's 1,024 primary rays, which cross the
    diagonals of its quads, and 5 of them disagree: the reference's
    kernel, in XLA's fused arithmetic, misses three that the port hits
    at u or v within 2e-8 of 0, and reports two as hits at t = tmax with
    u = v = 0 that the port and the reference's own intersect_bvh hit
    at t ~15.5."""
    (itiles, ltiles), count, tracer = scenes[name]
    if kind == "random":
        o, d, _, _ = _rays(2048, 11)
        o = o * 0.3          # origins inside the smaller scenes
    else:
        o, d = _primary_rays(name)
    R = o.shape[0]
    tmax = np.full(R, 1e6, np.float32)
    packed = tracer.packed
    args = (torch.from_numpy(o), torch.from_numpy(d), 0.01,
            torch.from_numpy(tmax), torch.ones(R, dtype=torch.bool))
    for any_hit in (True, False):
        rt, rtri, ru, rv = (np.asarray(x) for x in trace_pallas.intersect_packed(
            itiles, ltiles, count, jnp.asarray(o), jnp.asarray(d), 0.01,
            jnp.asarray(tmax), any_hit=any_hit, interpret=True))
        t, tri, u, v = (x.numpy() for x in trace_cuda.intersect_packet(
            packed, *args, any_hit))
        edge = ((tri >= 0) & _on_edge(u, v)) | ((rtri >= 0) & _on_edge(ru, rv))
        assert edge.mean() <= (0.015 if (name, kind) == ("cornell", "primary")
                               else 0.0)
        hit = rtri >= 0
        assert 0.05 < hit.mean() < 1.0
        np.testing.assert_array_equal((tri >= 0)[~edge], hit[~edge])
        if any_hit:
            continue
        hit = hit & ~edge
        np.testing.assert_allclose(t[hit], rt[hit], rtol=1e-5, atol=0)
        diff = np.nonzero((tri != rtri) & hit)[0]
        if diff.size:
            tv = packed.tri_verts
            corners = lambda ids: [tv[torch.from_numpy(ids).long(),
                                      3 * k:3 * k + 3] for k in range(3)]
            oo, dd = args[0][diff], args[1][diff]
            _, t_mine, _, _ = trace_cuda.ray_triangle(
                oo, dd, *corners(tri[diff]), 0.01, 1e6)
            _, t_ref, _, _ = trace_cuda.ray_triangle(
                oo, dd, *corners(rtri[diff]), 0.01, 1e6)
            np.testing.assert_allclose(t_mine.numpy(), t_ref.numpy(),
                                       rtol=1e-6, atol=0)
        same = hit & (tri == rtri)
        np.testing.assert_allclose(u[same], ru[same], rtol=0, atol=1e-5)
        np.testing.assert_allclose(v[same], rv[same], rtol=0, atol=1e-5)


def test_inactive_rays_and_per_ray_agreement(scenes):
    """Inactive rays report a miss (t inf, u = v = 0) and take no part;
    the active rays see what the per-ray K2 and K2c see: the same
    visibility and the same closest t."""
    packed = scenes["cornell"][2].packed
    o, d, tmax, active = (torch.from_numpy(x) for x in _rays(3000, 4))
    o = o * 0.3
    t, tri, u, v = trace_cuda.intersect_packet(packed, o, d, 0.01, tmax,
                                               active, False)
    assert (tri[~active] == -1).all() and torch.isinf(t[~active]).all()
    assert (u[~active] == 0).all() and (v[~active] == 0).all()
    rt, rtri, _, _ = trace_cuda.intersect_closest(packed, o, d, 0.01, tmax,
                                                  active)
    torch.testing.assert_close(t, rt, rtol=0, atol=0)
    anyhit = trace_cuda.intersect_packet(packed, o, d, 0.01, tmax, active,
                                         True)[1]
    ref_any = trace_cuda.intersect_any(packed, o, d, 0.01, tmax, active)
    assert torch.equal(anyhit >= 0, ref_any >= 0)
    assert 0.1 < (anyhit >= 0)[active].float().mean() < 1.0


def test_tile_order_and_packet_stack():
    """K2b's image packets at 20x12 are 8x4 tiles (edge tiles ragged,
    their dead lanes -1); pack_bvh holds a tree to the stack of the
    traversal it is packed for, K2b's 96 entries or K2's 64."""
    lanes = trace_cuda.packet_lanes(240, 20, "cpu")
    assert torch.equal(torch.sort(lanes[lanes >= 0]).values,
                       torch.arange(240))
    y, x = lanes[0] // 20, lanes[0] % 20
    assert (y < 4).all() and (x < 8).all()

    def chain(T):
        inner = np.arange(T - 1)
        left = np.full(2 * T - 1, -1, np.int32)
        right = np.full(2 * T - 1, -1, np.int32)
        left[inner] = inner + 1
        left[T - 2] = 2 * T - 2
        right[inner] = T - 1 + inner
        return types.SimpleNamespace(left=torch.from_numpy(left),
                                     right=torch.from_numpy(right))

    deep = chain(trace_cuda.PACKET_STACK_DEPTH + 1)
    with pytest.raises(ValueError, match="stack"):
        trace_cuda.pack_bvh(deep, None, None, None,
                            trace_cuda.PACKET_STACK_DEPTH)
    mid = chain(80)   # depth 79: K2b's stack holds it, K2's does not
    with pytest.raises(ValueError, match="stack"):
        trace_cuda.pack_bvh(mid, None, None, None)
    assert trace_cuda.tree_depth(**vars(mid)) + 1 \
        <= trace_cuda.PACKET_STACK_DEPTH


def test_tracer_queries_through_packets(scenes):
    """SceneTracer with trace_backend "pallas" against the per-ray
    tracer on cornell: shadow_query's visibility equal; trace_radiance
    (primary rays in 8x4 tile packets, with emissive-light NEE seeded by
    pixel index) equal in distance, and in colour to 1e-5 wherever both
    hit the same triangle: the pixels through the room's corner edges
    hit the two walls at the same t, and the packet and the ray settle
    the tie apart (reading: 10 of 576 pixels)."""
    packet = scenes["cornell"][2]
    per_ray = SceneTracer(packed=packet.packed, shade_rows=packet.shade_rows)
    ref_data = ref_scenes.cornell_scene().build()
    sc = scene_from_numpy(flatten(ref_data), "cpu")
    assert sc.lights.count > 0
    H = W = 24
    cam = OrbitCamera(width=W, height=H, **SCENES["cornell"][1]).step() \
        .to("cpu")
    d = composition.view_directions(cam, H, W, "cpu")
    o = cam.position.expand(H, W, 3)
    ctx = types.SimpleNamespace(
        params=FrameParams.create(sc, frame_index=3),
        settings=RenderSettings(width=W, height=H, flags=RenderFlags.LIGHT
                                | RenderFlags.IBL))
    rgb_p, dist_p = packet.trace_radiance(sc, o, d, ctx)
    rgb_r, dist_r = per_ray.trace_radiance(sc, o, d, ctx)
    torch.testing.assert_close(dist_p, dist_r, rtol=0, atol=0)
    assert (dist_p > 0).float().mean() > 0.5
    rays = per_ray.radiance_rays(o, d)
    tri_r = trace_cuda.intersect_closest(per_ray.packed, *rays[:2], 0.01,
                                         *rays[2:])[1]
    tri_p = trace_cuda.intersect_packet(packet.packed, *rays[:2], 0.01,
                                        *rays[2:], False, W)[1]
    same = (tri_p == tri_r).view(H, W)
    assert (~same).float().mean() <= 0.02
    torch.testing.assert_close(rgb_p[same], rgb_r[same], rtol=1e-5,
                               atol=1e-5)
    g = np.random.default_rng(2)
    pos = torch.from_numpy(g.uniform([-8, 0.2, -8], [8, 6, 8], (H, W, 3))
                           .astype(np.float32))
    nrm = torch.zeros((H, W, 3))
    nrm[..., 1] = 1.0
    sun = torch.from_numpy(g.standard_normal((H, W, 3)).astype(np.float32))
    sun[..., 1] = sun[..., 1].abs()
    sun = sun / sun.norm(dim=-1, keepdim=True)
    active = torch.from_numpy(g.random((H, W)) < 0.8)
    vis_p = packet.shadow_query(pos, nrm, sun, 1e10, active=active)
    vis_r = per_ray.shadow_query(pos, nrm, sun, 1e10, active=active)
    assert torch.equal(vis_p, vis_r)
    assert 0.0 < (vis_p[active] == 0).float().mean() < 1.0
