"""K2b's traversal (csrc/trace.cu trace_packet_kernel) replayed here in
PyTorch: a warp per packet over K2's records (ops/trace_cuda.pack_bvh
``inner_records`` / ``leaf_rows``), the near child kept in a register
and the warp's stack held across its lanes (entry k in slot k // 32 of
lane k % 32, a push one lane's move, a pop a shuffle), against the plain
version (``intersect_packet_plain``), which walks the per-node layout
with both children on its stack: the same nodes in the same order, and
the same triangle, t, u and v on every ray. The packets are the
kernel's: 32 consecutive rays, or with ``width`` one 8x4 pixel tile of
an image in pixel order (``packet_lanes``)."""
import numpy as np
import pytest
import torch

from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.ops import composition, trace_cuda
from hybridrenderer_tpu_torch.ops.trace import SceneTracer
from hybridrenderer_tpu_torch.scene import scene as scenes

from .torch_parity import chain_bvh

CAMS = {"cube": dict(distance=7.0, pitch=0.45, yaw=0.6,
                     focal_point=(0, 0.7, 0)),
        "cornell": dict(distance=13.0, focal_point=(0, 2.5, 0))}
PACKET = trace_cuda.PACKET


def _bits(x):
    return x.contiguous().view(torch.int32)


def tile_order(H, W):
    """The relayout the packet tracer used to make before K2b took
    ``width``: pixel indices in 8x4 tiles, row-major within a tile and
    tile-major across the image."""
    y = torch.arange(H).unsqueeze(1)
    x = torch.arange(W).unsqueeze(0)
    ntx = -(-W // 8)
    key = ((y // 4) * ntx + x // 8) * 32 + (y % 4) * 8 + x % 8
    return torch.argsort(key.reshape(-1))


def replay_packets(packed, o, d, tmin, tmax, active, any_hit, width=0):
    """The kernel's loop, all packets one step at a time → (t, tri, u, v
    per ray, the trail: each step's (P,) node of every packet, -1 for a
    packet that is done, in the plain version's node numbering, and the
    deepest stack)."""
    R = o.shape[0]
    n = packed.n_internal
    ray = trace_cuda.packet_lanes(R, width, o.device)
    P = ray.shape[0]
    ok = ray >= 0
    src = torch.clamp(ray, min=0)
    act = ok & active[src]
    org = torch.where(act.unsqueeze(-1), o[src], 0.0)
    dirs = torch.where(act.unsqueeze(-1), d[src], torch.tensor([0.0, 0.0,
                                                                1.0]))
    best = torch.where(act, torch.clamp(tmax[src], max=trace_cuda.PACKET_TMAX),
                       0.0)
    tiny = torch.where(dirs < 0, -1e-12, 1e-12)
    inv_d = 1.0 / torch.where(torch.abs(dirs) < 1e-12, tiny, dirs)
    rec = packed.inner_records.view(-1, 4, 4)
    rows = packed.leaf_rows.view(-1, 3, 4)
    pk = torch.arange(P)
    # the warp's stack across its lanes: [packet, lane, slot]
    slots = trace_cuda.PACKET_STACK_DEPTH // PACKET
    stack = torch.zeros((P, PACKET, slots), dtype=torch.long)
    sp = torch.zeros((P,), dtype=torch.long)
    ref = torch.full((P,), 0 if n > 0 else -1, dtype=torch.long)
    running = act.any(dim=1)
    out = torch.full((P, PACKET), -1, dtype=torch.int32)
    bu = torch.zeros((P, PACKET))
    bv = torch.zeros((P, PACKET))
    trail, deepest = [], 0
    while bool(running.any()):
        trail.append(torch.where(running, torch.where(ref >= 0, ref,
                                                      n - 1 - ref), -1))
        inner = running & (ref >= 0)
        leaf = running & (ref < 0)
        popped = leaf.clone()
        if n > 0:
            r = rec[torch.clamp(ref, 0, n - 1)]
            lref, rref = _bits(r[:, 0, 3]).long(), _bits(r[:, 2, 3]).long()
            lane_live = inner.unsqueeze(1) & act
            if any_hit:
                lane_live = lane_live & (out < 0)

            def vote(lo, hi):
                hit, tn = trace_cuda.ray_aabb(org, inv_d, lo.unsqueeze(1),
                                              hi.unsqueeze(1), tmin, best)
                hit = hit & lane_live
                return hit.any(dim=1), trace_cuda._warp_sum(
                    torch.where(hit, tn, 0.0))

            (l_any, l_sum), (r_any, r_sum) = (vote(r[:, 0, :3], r[:, 1, :3]),
                                              vote(r[:, 2, :3], r[:, 3, :3]))
            # the sums decide only where both children are taken
            go_left = torch.where(r_any, l_any & (l_sum <= r_sum), True)
            push = inner & l_any & r_any
            assert not bool((push & (sp >= slots * PACKET)).any()), \
                "stack overflow"
            lane, slot = sp % PACKET, torch.clamp(sp // PACKET, max=slots - 1)
            far = torch.where(go_left, rref, lref)
            stack[pk, lane, slot] = torch.where(push, far,
                                                stack[pk, lane, slot])
            sp = sp + push.long()
            deepest = max(deepest, int(sp.max()))
            taken = inner & (l_any | r_any)
            ref = torch.where(taken, torch.where(go_left, lref, rref), ref)
            popped = popped | (inner & ~taken)
        row = rows[torch.clamp(-1 - ref, min=0)]
        tri = _bits(row[:, 0, 3])
        hit, t, u, v = trace_cuda.ray_triangle_edges(
            org, dirs, row[:, 0, :3].unsqueeze(1), row[:, 1, :3].unsqueeze(1),
            row[:, 2, :3].unsqueeze(1), tmin, best)
        take = (leaf & (tri >= 0)).unsqueeze(1) & act & hit
        out = torch.where(take, tri.unsqueeze(1), out)
        best = torch.where(take, t, best)
        bu = torch.where(take, u, bu)
        bv = torch.where(take, v, bv)
        if any_hit:
            # after a leaf, the warp is done once every active lane has
            # a hit
            running = running & ~(leaf & (~act | (out >= 0)).all(dim=1))
        running = running & ~(popped & (sp == 0))
        pop = popped & running
        sp = torch.where(pop, sp - 1, sp)
        top = stack[pk, torch.clamp(sp, min=0) % PACKET,
                    torch.clamp(sp, min=0) // PACKET]
        ref = torch.where(pop, top, ref)
    t = torch.where(out < 0, torch.full_like(best, float("inf")), best)

    def flat(x):
        y = x.new_empty((R,))
        y[ray[ok]] = x[ok]
        return y

    return flat(t), flat(out), flat(bu), flat(bv), trail, deepest


def _scene(name):
    return SceneTracer.build(getattr(scenes, name + "_scene")().build("cpu"),
                             RenderSettings(trace_backend="pallas")).packed


def _queries(name):
    """(rays, width): primary rays of a 36x20 image in pixel order (8x4
    tiles cut at the right edge), and 1,000 random rays from inside the
    scene with a fifth inactive."""
    W, H = 36, 20
    cam = OrbitCamera(width=W, height=H, **CAMS[name]).step().to("cpu")
    d = composition.view_directions(cam, H, W, "cpu").reshape(-1, 3)
    o = cam.position.expand(H * W, 3).contiguous()
    primary = (o, d.contiguous(), torch.full((H * W,), 1e6),
               torch.ones(H * W, dtype=torch.bool))
    g = np.random.default_rng(6)
    R = 1000
    ro = g.uniform(-1.5, 1.5, (R, 3)) + np.array(CAMS[name]["focal_point"])
    rd = g.standard_normal((R, 3))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    rnd = (torch.from_numpy(ro.astype(np.float32)),
           torch.from_numpy(rd.astype(np.float32)),
           torch.from_numpy(g.choice([2.0, 1e6], R).astype(np.float32)),
           torch.from_numpy(g.random(R) < 0.8))
    return [(primary, W), (rnd, 0)]


def _chain_queries():
    """Rays along the depth-95 chain (torch_parity.chain_bvh): along -x
    from beyond its last triangle every chain node's box is nearer than
    its leaf, so the far children pile up on the stack; along +x each
    leaf is nearer."""
    g = np.random.default_rng(8)
    R = 256
    side = np.arange(R) % 64 < 32
    o = np.stack([np.where(side, 120.0, -20.0), g.uniform(-0.4, 0.4, R),
                  g.uniform(-0.4, 0.4, R)], 1)
    d = np.stack([np.where(side, -1.0, 1.0), g.uniform(-0.01, 0.01, R),
                  g.uniform(-0.01, 0.01, R)], 1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    return [((t(o), t(d), torch.full((R,), 1e6), torch.ones(R, dtype=bool)),
             0)]


def _case(name):
    if name == "chain95":
        tree, *v = chain_bvh(trace_cuda.PACKET_STACK_DEPTH)
        return trace_cuda.pack_bvh(tree, *v, trace_cuda.PACKET_STACK_DEPTH), \
            _chain_queries()
    return _scene(name), _queries(name)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("name", ["cube", "cornell", "chain95"])
def test_replayed_kernel_visits_plain_order(name, any_hit):
    """The replayed kernel and the plain version visit the same node in
    every step of every packet and agree bit for bit on every ray; on
    the depth-95 chain the lane-distributed stack fills all three slots,
    to the tree's depth."""
    packed, queries = _case(name)
    for (o, d, tmax, active), width in queries:
        trail = []
        p = trace_cuda.intersect_packet_plain(packed, o, d, 0.01, tmax,
                                              active, any_hit, width,
                                              trail=trail)
        *k, k_trail, deepest = replay_packets(packed, o, d, 0.01, tmax,
                                              active, any_hit, width)
        assert len(k_trail) == len(trail)
        for a, b in zip(k_trail, trail):
            assert torch.equal(a, b)
        assert torch.equal(k[1], p[1])
        for a, b in zip(k, p):
            assert torch.equal(_bits(a), _bits(b))
        assert (p[1][~active] == -1).all()
        assert (p[1] >= 0).float().mean().item() > 0.05
        if name == "chain95" and not any_hit:
            assert deepest == packed.depth == trace_cuda.PACKET_STACK_DEPTH - 1


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("name", ["cube", "cornell"])
def test_width_packets_are_tile_order_packets(name, any_hit):
    """At a whole-tile size (32x32) the plain version with ``width`` on
    pixel-order rays forms the packets it forms on rays relayouted into
    8x4 tiles: every output equal bit for bit, pixel for pixel."""
    packed = _scene(name)
    S = 32
    cam = OrbitCamera(width=S, height=S, **CAMS[name]).step().to("cpu")
    d = composition.view_directions(cam, S, S, "cpu").reshape(-1, 3)
    o = cam.position.expand(S * S, 3).contiguous()
    tmax = torch.full((S * S,), 1e6)
    act = torch.from_numpy(np.random.default_rng(3).random(S * S) < 0.9)
    mine = trace_cuda.intersect_packet_plain(packed, o, d.contiguous(), 0.01,
                                             tmax, act, any_hit, S)
    perm = tile_order(S, S)
    tiled = trace_cuda.intersect_packet_plain(
        packed, o[perm].contiguous(), d[perm].contiguous(), 0.01, tmax[perm],
        act[perm], any_hit)
    for a, b in zip(mine, tiled):
        assert torch.equal(_bits(a[perm]), _bits(b))
    assert (mine[1] >= 0).float().mean().item() > 0.3


def test_ragged_packets_stay_in_one_tile():
    """packet_lanes at 20x12 (tiles cut at the right edge) and for two
    such images stacked (the tracer's sun + light occlusion call): every
    ray in exactly one packet, every packet inside one 8x4 pixel tile,
    rows of a tile row-major in its lanes; without width, 32 consecutive
    rays."""
    W, H = 20, 12
    for R in (W * H, 2 * W * H):
        ray = trace_cuda.packet_lanes(R, W, "cpu")
        live = ray[ray >= 0]
        assert torch.equal(torch.sort(live).values, torch.arange(R))
        for lanes in ray:
            mine = lanes[lanes >= 0]
            y, x = mine // W, mine % W
            assert (y // 4 == y[0] // 4).all() and (x // 8 == x[0] // 8).all()
            assert torch.equal(mine, torch.sort(mine).values)
    assert ray.shape[0] == 3 * 6   # 3 tile columns, 6 tile rows
    flat = trace_cuda.packet_lanes(70, 0, "cpu")
    assert flat.shape == (3, PACKET)
    assert torch.equal(flat.reshape(-1)[:70], torch.arange(70))
    assert (flat.reshape(-1)[70:] == -1).all()


def test_tracer_hands_packets_pixel_order(monkeypatch):
    """The packet tracer (trace_backend "pallas") hands K2b the rays of
    an image query in pixel order with the image's width, no relayout:
    shadow_query and trace_radiance's primary rays and their occlusion
    rays."""
    from hybridrenderer_tpu_torch.graph.params import FrameParams
    from hybridrenderer_tpu_torch.ops import trace
    import types

    data = scenes.cornell_scene().build("cpu")
    tracer = SceneTracer.build(data, RenderSettings(trace_backend="pallas"))
    assert tracer.packed.inner_records is not None
    calls, real = [], trace.intersect_packet

    def recording(packed, o, d, tmin, tmax, active, any_hit, width=0):
        calls.append((o, d, any_hit, width))
        return real(packed, o, d, tmin, tmax, active, any_hit, width)

    monkeypatch.setattr(trace, "intersect_packet", recording)
    H, W = 12, 20
    cam = OrbitCamera(width=W, height=H, **CAMS["cornell"]).step().to("cpu")
    d = composition.view_directions(cam, H, W, "cpu")
    o = cam.position.expand(H, W, 3)
    ctx = types.SimpleNamespace(
        params=FrameParams.create(data, frame_index=2),
        settings=RenderSettings(width=W, height=H))
    tracer.trace_radiance(data, o, d, ctx)
    assert [(c[2], c[3]) for c in calls] == [(False, W), (True, W)]
    assert torch.equal(calls[0][0], o.reshape(-1, 3))
    assert torch.equal(calls[0][1], d.reshape(-1, 3))
    # sun and light occlusion: two images of W columns, one above the other
    assert calls[1][0].shape == (2 * H * W, 3)
    calls.clear()
    nrm = torch.zeros((H, W, 3))
    nrm[..., 1] = 1.0
    sun = torch.nn.functional.normalize(torch.tensor([0.3, 1.0, 0.2]), dim=0)
    tracer.shadow_query(o, nrm, sun.expand(H, W, 3), 100.0)
    assert len(calls) == 1 and calls[0][2:] == (True, W)
    rays = tracer.shadow_rays(o, nrm, sun.expand(H, W, 3), 100.0)
    assert torch.equal(calls[0][0], rays[0])
