"""BVH traversal: kernels K2 (any-hit) and K2c (closest-hit) and their
plain version (hybridrenderer_tpu/ops/trace_pallas.py in its two modes;
the plain version follows ops/trace.py intersect_bvh), and the packet
traversal K2b (trace_pallas.py _traverse_kernel, trace_backend
"pallas") with its plain version.

``pack_bvh`` lays the binary BVH out for the kernels: per node two float4
(min xyz + left child id bits, max xyz + right child id bits), the leaf
triangle ids, and the triangle corners as (T, 9) floats.
``intersect_any`` returns, per ray, the id of a triangle hit with
tmin <= t <= tmax, or -1. ``intersect_closest`` returns (t, tri, u, v)
of the nearest such hit, with t = +inf, tri = -1 and u = v = 0 on a miss.
Neither caps its iterations: the reference's ``max_iters`` batch cap of
10,000 steps is never reached on a tree the stack can hold.
``intersect_packet`` answers either query for packets of 32 consecutive
rays that share one stack; its visiting order, and so its choice among
equal-t hits, is the packet's, not a ray's.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .. import native
from ..core import maths

TRI_EPS = 1e-9
STACK_DEPTH = 64
PACKET = 32                # rays per packet: one warp
PACKET_STACK_DEPTH = 96    # trace_pallas.STACK_DEPTH
PACKET_TMAX = 1e6          # intersect_packed's tmax clamp
KERNEL = native.KERNELS["trace_any"]
KERNEL_CLOSEST = native.KERNELS["trace_closest"]
KERNEL_PACKET = native.KERNELS["trace_packet"]


@dataclasses.dataclass
class PackedBVH:
    nodes: Any       # (N, 8) f32: min xyz, left bits, max xyz, right bits
    node_tri: Any    # (N,) i32 triangle id of leaves, -1 internal
    tri_verts: Any   # (T, 9) f32 triangle corners
    n_internal: int
    depth: int       # of the deepest leaf; the root is at depth 0


def tree_depth(left, right) -> int:
    """Depth of the deepest leaf (the root is at depth 0)."""
    lo, hi = left.cpu().numpy(), right.cpu().numpy()
    level, depth = np.zeros(1, np.int64), 0
    while True:
        inner = level[lo[level] >= 0]
        if inner.size == 0:
            return depth
        level = np.concatenate([lo[inner], hi[inner]])
        depth += 1


def _check_depth(depth, stack):
    if depth + 1 > stack:
        raise ValueError(f"BVH of depth {depth} needs a traversal stack of "
                         f"{depth + 1} entries; the kernel has {stack}")


def pack_bvh(bvh, v0, v1, v2, stack=STACK_DEPTH) -> PackedBVH:
    """Raises if the tree is too deep for the traversal's stack of
    ``stack`` entries (K2's 64, or K2b's 96): popping a node at depth k
    leaves at most k entries, and its two children make k + 2, so a tree
    of depth D needs D + 1 entries. Within that bound neither kernel nor
    its plain version ever drops a child."""
    depth = tree_depth(bvh.left, bvh.right)
    _check_depth(depth, stack)
    bits = lambda x: x.to(torch.int32).view(torch.float32).unsqueeze(-1)
    nodes = torch.cat([bvh.node_min, bits(bvh.left), bvh.node_max,
                       bits(bvh.right)], dim=-1).contiguous()
    return PackedBVH(nodes=nodes, node_tri=bvh.tri.to(torch.int32).contiguous(),
                     tri_verts=torch.cat([v0, v1, v2], -1).contiguous(),
                     n_internal=bvh.num_tris - 1, depth=depth)


def _check_rays(bvh: PackedBVH, o, d, tmax, active, stack=STACK_DEPTH):
    dev = o.device
    R = o.shape[0]
    _check_depth(bvh.depth, stack)
    native.check(bvh.nodes, "nodes", torch.float32, (None, 8), dev)
    native.check(bvh.node_tri, "node_tri", torch.int32, (None,), dev)
    native.check(bvh.tri_verts, "tri_verts", torch.float32, (None, 9), dev)
    native.check(o, "o", torch.float32, (R, 3), dev)
    native.check(d, "d", torch.float32, (R, 3), dev)
    native.check(tmax, "tmax", torch.float32, (R,), dev)
    native.check(active, "active", torch.bool, (R,), dev)
    return R


def intersect_any(bvh: PackedBVH, o, d, tmin: float, tmax, active):
    """Rays (R, 3) o, d; tmax (R,) f32; active (R,) bool → tri (R,) i32.

    CUDA tensors launch kernel K2, which replaces the TPU kernel
    trace_pallas._wide_direct_kernel (any-hit); CPU tensors take the
    plain version. On the card the kernel is bound by the latency of its
    dependent node loads; see csrc/trace.cu."""
    if o.device.type == "cpu":
        return intersect_any_plain(bvh, o, d, tmin, tmax, active)
    if o.device.type != "cuda":
        raise ValueError(f"intersect_any: unsupported device {o.device}")
    R = _check_rays(bvh, o, d, tmax, active)
    out = torch.empty((R,), dtype=torch.int32, device=o.device)
    KERNEL.launch("hr_trace_any", native.ptr(bvh.nodes),
                  native.ptr(bvh.node_tri), native.ptr(bvh.tri_verts),
                  bvh.n_internal, native.ptr(o), native.ptr(d),
                  native.ptr(tmax), native.ptr(active), float(tmin), R,
                  native.ptr(out))
    return out


def intersect_closest(bvh: PackedBVH, o, d, tmin: float, tmax, active):
    """Rays (R, 3) o, d; tmax (R,) f32; active (R,) bool → (t, tri, u, v)
    of the nearest hit, each (R,), tri i32.

    CUDA tensors launch kernel K2c, which replaces the TPU kernel
    trace_pallas._wide_direct_kernel (closest-hit); CPU tensors take the
    plain version. Bound on the card like K2; see csrc/trace.cu."""
    if o.device.type == "cpu":
        return intersect_closest_plain(bvh, o, d, tmin, tmax, active)
    if o.device.type != "cuda":
        raise ValueError(f"intersect_closest: unsupported device {o.device}")
    R = _check_rays(bvh, o, d, tmax, active)
    t, u, v = (torch.empty((R,), dtype=torch.float32, device=o.device)
               for _ in range(3))
    tri = torch.empty((R,), dtype=torch.int32, device=o.device)
    KERNEL_CLOSEST.launch(
        "hr_trace_closest", native.ptr(bvh.nodes), native.ptr(bvh.node_tri),
        native.ptr(bvh.tri_verts), bvh.n_internal, native.ptr(o),
        native.ptr(d), native.ptr(tmax), native.ptr(active), float(tmin), R,
        native.ptr(t), native.ptr(tri), native.ptr(u), native.ptr(v))
    return t, tri, u, v


def intersect_packet(bvh: PackedBVH, o, d, tmin: float, tmax, active,
                     any_hit: bool):
    """Packet traversal of rays (R, 3) o, d; tmax (R,) f32; active (R,)
    bool, in packets of 32 consecutive rays → (t, tri, u, v), each (R,),
    as ``intersect_closest`` reports them; any-hit's tri is a triangle
    hit, or -1, and its t, u, v are those of that hit.

    CUDA tensors launch kernel K2b, which replaces the TPU kernel
    trace_pallas._traverse_kernel; CPU tensors take the plain version.
    On the card a warp is a packet: one node load serves its 32 rays;
    see csrc/trace.cu."""
    if o.device.type == "cpu":
        return intersect_packet_plain(bvh, o, d, tmin, tmax, active, any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"intersect_packet: unsupported device {o.device}")
    R = _check_rays(bvh, o, d, tmax, active, PACKET_STACK_DEPTH)
    t, u, v = (torch.empty((R,), dtype=torch.float32, device=o.device)
               for _ in range(3))
    tri = torch.empty((R,), dtype=torch.int32, device=o.device)
    KERNEL_PACKET.launch(
        "hr_trace_packet", native.ptr(bvh.nodes), native.ptr(bvh.node_tri),
        native.ptr(bvh.tri_verts), bvh.n_internal, native.ptr(o),
        native.ptr(d), native.ptr(tmax), native.ptr(active), float(tmin), R,
        int(any_hit), native.ptr(t), native.ptr(tri), native.ptr(u),
        native.ptr(v))
    return t, tri, u, v


def _warp_sum(x):
    """(P, 32) → (P,): the kernel's xor-butterfly sum, whose every lane
    ends with v[0] + v[16] first, then pairs of those at offset 8, ..."""
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return x[:, 0]


def intersect_packet_plain(bvh: PackedBVH, o, d, tmin: float, tmax, active,
                           any_hit: bool, visits=None):
    """Plain PyTorch version of kernel K2b: all packets step together,
    one node per packet per step, with the kernel's votes, sums and
    visiting order. ``visits``, a dict, receives the number of internal
    and leaf nodes the packets visit."""
    KERNEL_PACKET.note_plain(o)
    dev = o.device
    R = o.shape[0]
    P = -(-R // PACKET)
    pad = P * PACKET - R

    def lanes(x, fill):
        x = torch.cat([x, x.new_full((pad, *x.shape[1:]), fill)])
        return x.view(P, PACKET, *x.shape[1:])

    # inactive and padding lanes take part in no vote and no hit
    act = lanes(active, False)
    org = lanes(o, 0.0)
    dirs = lanes(d, 1.0)
    best = lanes(torch.clamp(tmax, max=PACKET_TMAX), 0.0)
    tiny = torch.where(dirs < 0, -1e-12, 1e-12)
    inv_d = 1.0 / torch.where(torch.abs(dirs) < 1e-12, tiny, dirs)
    node_min = bvh.nodes[:, 0:3]
    node_max = bvh.nodes[:, 4:7]
    left_of = bvh.nodes[:, 3].contiguous().view(torch.int32).long()
    right_of = bvh.nodes[:, 7].contiguous().view(torch.int32).long()
    tv = bvh.tri_verts
    T = tv.shape[0]

    pk = torch.arange(P, device=dev)
    stack = torch.zeros((P, PACKET_STACK_DEPTH), dtype=torch.long,
                        device=dev)
    sp = act.any(dim=1).long()
    out = torch.full((P, PACKET), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros((P, PACKET), dtype=torch.float32, device=dev)
    bv = torch.zeros((P, PACKET), dtype=torch.float32, device=dev)
    n_inner = n_leaf = torch.zeros((), dtype=torch.int64, device=dev)
    while True:
        live = sp > 0
        if any_hit:
            live = live & ~(~act | (out >= 0)).all(dim=1)
        if not bool(live.any()):
            break
        sp = torch.where(live, sp - 1, sp)
        node = torch.where(live, stack[pk, torch.clamp(sp, min=0)], 0)

        is_leaf = node >= bvh.n_internal
        tri = bvh.node_tri[node]
        safe = torch.clamp(tri, 0, T - 1).long()
        corner = lambda k: tv[safe, 3 * k:3 * k + 3].unsqueeze(1)
        hit, t, u, v = ray_triangle(org, dirs, corner(0), corner(1),
                                    corner(2), tmin, best)
        take = (live & is_leaf & (tri >= 0)).unsqueeze(1) & act & hit
        out = torch.where(take, tri.unsqueeze(1), out)
        best = torch.where(take, t, best)
        bu = torch.where(take, u, bu)
        bv = torch.where(take, v, bv)

        inner = live & ~is_leaf
        if visits is not None:
            n_inner = n_inner + inner.sum()
            n_leaf = n_leaf + (live & is_leaf).sum()
        lane_live = inner.unsqueeze(1) & act
        if any_hit:
            lane_live = lane_live & (out < 0)
        left = torch.where(inner, left_of[node], 0)
        right = torch.where(inner, right_of[node], 0)

        def box(child):
            ok, tn = ray_aabb(org, inv_d, node_min[child].unsqueeze(1),
                              node_max[child].unsqueeze(1), tmin, best)
            ok = ok & lane_live
            return ok.any(dim=1), _warp_sum(torch.where(ok, tn, 0.0))

        (l_any, l_sum), (r_any, r_sum) = box(left), box(right)
        l_nearer = l_sum <= r_sum
        for child, ok in ((torch.where(l_nearer, right, left),
                           torch.where(l_nearer, r_any, l_any)),
                          (torch.where(l_nearer, left, right),
                           torch.where(l_nearer, l_any, r_any))):
            slot = torch.clamp(sp, max=PACKET_STACK_DEPTH - 1)
            stack[pk, slot] = torch.where(ok, child, stack[pk, slot])
            sp = sp + ok.long()
    if visits is not None:
        visits["internal"] = visits.get("internal", 0) + int(n_inner)
        visits["leaf"] = visits.get("leaf", 0) + int(n_leaf)
    flat = lambda x: x.reshape(-1)[:R]
    t = torch.where(out < 0, torch.full_like(best, float("inf")), best)
    return flat(t), flat(out), flat(bu), flat(bv)


def ray_triangle(o, d, p0, p1, p2, tmin, tmax):
    """Möller–Trumbore, both-faced → (hit, t, u, v)."""
    e1 = p1 - p0
    e2 = p2 - p0
    pvec = maths.cross(d, e2)
    det = maths.dot(e1, pvec)
    inv_det = 1.0 / torch.where(torch.abs(det) < TRI_EPS,
                                torch.full_like(det, TRI_EPS), det)
    tvec = o - p0
    u = maths.dot(tvec, pvec) * inv_det
    qvec = maths.cross(tvec, e1)
    v = maths.dot(d, qvec) * inv_det
    t = maths.dot(e2, qvec) * inv_det
    hit = ((torch.abs(det) >= TRI_EPS) & (u >= 0.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t >= tmin) & (t <= tmax))
    return hit, t, u, v


def ray_aabb(o, inv_d, bmin, bmax, tmin, tmax):
    """Slab test → (hit, entry distance)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    return (tn <= tf) & (tf >= tmin) & (tn <= tmax), tn


def intersect_any_plain(bvh: PackedBVH, o, d, tmin: float, tmax, active,
                        visits=None):
    """Plain PyTorch version of kernel K2. ``visits``, a dict, receives
    the number of internal and leaf nodes the rays visit."""
    KERNEL.note_plain(o)
    return _traverse_plain(bvh, o, d, tmin, tmax, active, True, visits)[1]


def intersect_closest_plain(bvh: PackedBVH, o, d, tmin: float, tmax,
                            active, visits=None):
    """Plain PyTorch version of kernel K2c; ``visits`` as for K2."""
    KERNEL_CLOSEST.note_plain(o)
    t, tri, u, v = _traverse_plain(bvh, o, d, tmin, tmax, active, False,
                                   visits)
    return torch.where(tri < 0, torch.full_like(t, float("inf")), t), tri, \
        u, v


def _traverse_plain(bvh: PackedBVH, o, d, tmin: float, tmax, active,
                    any_hit: bool, visits=None):
    """Every ray keeps its own stack and all rays step together, one node
    per ray per step, in the kernels' visiting order. Child boxes are
    tested against each ray's best t so far; a leaf hit with t <= best
    replaces it (any-hit: ends the ray). → (best t, tri, u, v)."""
    dev = o.device
    R = o.shape[0]
    node_min = bvh.nodes[:, 0:3]
    node_max = bvh.nodes[:, 4:7]
    left_of = bvh.nodes[:, 3].contiguous().view(torch.int32).long()
    right_of = bvh.nodes[:, 7].contiguous().view(torch.int32).long()
    tv = bvh.tri_verts
    T = tv.shape[0]
    tiny = torch.where(d < 0, -1e-12, 1e-12)
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-12, tiny, d)

    rows = torch.arange(R, device=dev)
    stack = torch.zeros((R, STACK_DEPTH), dtype=torch.long, device=dev)
    sp = active.long()                       # inactive rays start empty
    best = tmax.clone()
    out = torch.full((R,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros((R,), dtype=torch.float32, device=dev)
    bv = torch.zeros((R,), dtype=torch.float32, device=dev)
    n_inner = n_leaf = torch.zeros((), dtype=torch.int64, device=dev)
    while bool((sp > 0).any()):
        live = sp > 0
        sp = torch.where(live, sp - 1, sp)
        node = torch.where(live, stack[rows, torch.clamp(sp, min=0)], 0)

        is_leaf = node >= bvh.n_internal
        tri = bvh.node_tri[node]
        safe = torch.clamp(tri, 0, T - 1).long()
        hit, t, u, v = ray_triangle(o, d, tv[safe, 0:3], tv[safe, 3:6],
                                    tv[safe, 6:9], tmin, best)
        take = live & is_leaf & hit & (tri >= 0)
        out = torch.where(take, tri, out)
        best = torch.where(take, t, best)
        bu = torch.where(take, u, bu)
        bv = torch.where(take, v, bv)
        if any_hit:
            sp = torch.where(take, 0, sp)

        inner = live & ~is_leaf
        if visits is not None:
            n_inner = n_inner + inner.sum()
            n_leaf = n_leaf + (live & is_leaf).sum()
        left = torch.where(inner, left_of[node], 0)
        right = torch.where(inner, right_of[node], 0)
        lhit, lt = ray_aabb(o, inv_d, node_min[left], node_max[left], tmin,
                            best)
        rhit, rt = ray_aabb(o, inv_d, node_min[right], node_max[right], tmin,
                            best)
        lhit, rhit = lhit & inner, rhit & inner
        l_nearer = lt <= rt
        for child, ok in ((torch.where(l_nearer, right, left),
                           torch.where(l_nearer, rhit, lhit)),
                          (torch.where(l_nearer, left, right),
                           torch.where(l_nearer, lhit, rhit))):
            push = ok & (sp < STACK_DEPTH)
            slot = torch.clamp(sp, max=STACK_DEPTH - 1)
            stack[rows, slot] = torch.where(push, child, stack[rows, slot])
            sp = sp + push.long()
    if visits is not None:
        visits["internal"] = visits.get("internal", 0) + int(n_inner)
        visits["leaf"] = visits.get("leaf", 0) + int(n_leaf)
    return best, out, bu, bv
