"""BVH traversal: kernels K2 (any-hit) and K2c (closest-hit) and their
plain version (hybridrenderer_tpu/ops/trace_pallas.py in its two modes;
the plain version follows ops/trace.py intersect_bvh), and the packet
traversal K2b (trace_pallas.py _traverse_kernel, trace_backend
"pallas") with its plain version.

``pack_bvh`` lays the binary BVH out twice. The plain versions read per
node two float4 (min xyz + left child id bits, max xyz + right child id
bits) and the leaf triangle ids. K2, K2c and K2b read one record per
internal node holding both children's boxes and references
(``inner_records``). Kernels and plain versions alike test a leaf's
triangle from its row of ``leaf_rows``: v0, e1 = v1 - v0 and
e2 = v2 - v0 (or the bf16-rounded edges of a quantized scene, which no
subtraction of corners gives back); see csrc/trace.cu.
``intersect_any`` returns, per ray, the id of a triangle hit with
tmin <= t <= tmax, or -1. ``intersect_closest`` returns (t, tri, u, v)
of the nearest such hit, with t = +inf, tri = -1 and u = v = 0 on a miss.
Neither caps its iterations: the reference's ``max_iters`` batch cap of
10,000 steps is never reached on a tree the stack can hold.
``intersect_packet`` answers either query for packets of 32 rays that
share one stack: 32 consecutive rays, or the 8x4 pixel tiles of an
image (``packet_lanes``); its visiting order, and so its choice among
equal-t hits, is the packet's, not a ray's.

``intersect_wide`` (K2w, trace_pallas.py _wide_traverse_kernel) and
``intersect_mimt`` (K2m, _mimt_traverse_kernel) walk the 8-wide tree of
ops/bvh_wide.py (K2w with 4, 8 or 16 triangles a leaf cluster, K2m with
4) in packets of 1024 consecutive rays, with the
reference's contract: (t, tri, u, v) with t = +inf and tri = -1 on a
miss, and tri = INACTIVE_TRI, t = -1 for an inactive ray. Both follow
the reference's visiting order step for step, its termination rule
included, so they report the reference kernels' triangles.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import native
from ..core import maths

TRI_EPS = 1e-9
STACK_DEPTH = 64
PACKET = 32                # rays per packet: one warp
PACKET_STACK_DEPTH = 96    # trace_pallas.STACK_DEPTH
PACKET_TMAX = 1e6          # intersect_packed's tmax clamp
PACKET_TILE_W, PACKET_TILE_H = 8, 4   # an image packet's pixel tile
KERNEL = native.KERNELS["trace_any"]
KERNEL_CLOSEST = native.KERNELS["trace_closest"]
KERNEL_PACKET = native.KERNELS["trace_packet"]
KERNEL_WIDE = native.KERNELS["trace_wide"]
KERNEL_MIMT = native.KERNELS["trace_mimt"]
# K2w / K2m (trace_pallas.py:406-446): 1024-ray packets, two packets a
# program that step together until both are done, liveness tested every
# WIDE_CHUNK steps, at most WIDE_MAX_STEPS steps. Internal-node stacks
# have the TPU kernels' 128 entries (their 128-lane register stacks),
# enough for any tree the build accepts (check_wide_stacks). The leaf
# stacks are not bounded by the depth: on the stress scene a packet's
# leaf stack reaches ~150 entries, where the reference drops pushes past
# 128 and misses their triangles. The port's leaf stacks hold
# WIDE_LEAF_STACK entries, and a packet (K2m: a row) whose leaf stack
# could overflow this step pops no internal node, only a leaf: the
# visiting order is the reference's wherever the reference drops
# nothing, and no push is ever dropped
WIDE_PACKET = 1024
WIDE_PAIR = 2
WIDE_CHUNK = 16
WIDE_MAX_STEPS = 1 << 16
WIDE_STACK = 128
WIDE_LEAF_STACK = 512
WIDE_ROWS = 8              # K2m: one stack pair per 128-ray row
INACTIVE_TRI = 1 << 29     # trace_pallas.INACTIVE_TRI


class PackTopology(NamedTuple):
    """What ``pack_bvh`` derives from the tree's shape alone; a refit,
    which keeps the shape, reuses it."""
    kids: Any        # (n_internal, 2) i64: each internal node's children
    refs: Any        # (N, 1) f32: each node's reference bits (child_ref)
    zero: Any        # (N, 1) f32 zeros
    leaf_tri: Any    # (n_internal + 1,) i64: leaf k's triangle, >= 0


@dataclasses.dataclass
class PackedBVH:
    nodes: Any       # (N, 8) f32: min xyz, left bits, max xyz, right bits
    node_tri: Any    # (N,) i32 triangle id of leaves, -1 internal
    tri_verts: Any   # (T, 9) f32 triangle corners (the traversals read
    #                  ``leaf_rows``)
    n_internal: int
    depth: int       # of the deepest leaf; the root is at depth 0
    # K2, K2c and K2b's records: (n_internal, 16) f32, internal node i's
    # children: left min xyz + ref bits, left max xyz + 0, right min xyz
    # + ref bits, right max xyz + 0 (``child_ref``)
    inner_records: Any
    # (n_internal + 1, 12) f32, leaf k's triangle: v0 xyz + id bits,
    # e1 = v1 - v0 xyz + 0, e2 = v2 - v0 xyz + 0
    leaf_rows: Any
    topology: PackTopology


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


def _bits(x):
    return x.to(torch.int32).view(torch.float32)


def pack_bvh(bvh, v0, v1, v2, stack=STACK_DEPTH, like=None,
             edges=None) -> PackedBVH:
    """The binary tree ``bvh`` over triangles (v0, v1, v2) in the
    per-node layout the plain versions read and in the kernels' records,
    built on their device with no host sync but the depth walk. Raises if
    the tree is too deep for the traversal's stack of ``stack`` entries
    (K2's 64, or K2b's 96): popping a node at depth k leaves at most k
    entries, and its two children make k + 2, so a tree of depth D needs
    D + 1 entries in the plain versions (the kernels, which keep the near
    child in a register, need D). Within that bound no kernel nor plain
    version ever drops a child. ``like``, a packing of a tree of the same
    shape (a refit's), lends its depth and topology: no host walk, and
    five device operations for the records. ``edges`` (e1, e2), each
    (T, 3), are the leaves' edges where they are not v1 - v0 and v2 - v0
    (the bf16 triangles of ops/bvh_wide.quantize_triangles, whose
    rounded edges a subtraction of corners would not give back)."""
    depth = tree_depth(bvh.left, bvh.right) if like is None else like.depth
    _check_depth(depth, stack)
    n = bvh.num_tris - 1
    nodes = torch.cat([bvh.node_min, _bits(bvh.left).unsqueeze(-1),
                       bvh.node_max, _bits(bvh.right).unsqueeze(-1)], dim=-1)
    node_tri = bvh.tri.to(torch.int32).contiguous()
    tri_verts = torch.cat([v0, v1, v2], -1)
    if like is None:
        kids = nodes[:n, [3, 7]].contiguous().view(torch.int32)
        node = torch.arange(2 * n + 1, device=nodes.device)
        topo = PackTopology(
            kids=kids.long(), refs=_bits(child_ref(node, n)).unsqueeze(-1),
            zero=nodes.new_zeros((2 * n + 1, 1)),
            leaf_tri=torch.clamp(node_tri[n:], min=0).long())
    else:
        topo = like.topology
    # each child's box and reference, gathered into its parent's record
    inner = torch.cat([nodes[:, :3], topo.refs, nodes[:, 4:7], topo.zero],
                      dim=-1)[topo.kids]
    # leaf k's triangle: v0 and the id, e1 = v1 - v0, e2 = v2 - v0
    corners = tri_verts[topo.leaf_tri].view(-1, 3, 3)
    if edges is None:
        e = corners[:, 1:] - corners[:, :1]
        e1, e2 = e[:, 0], e[:, 1]
    else:
        e1, e2 = edges[0][topo.leaf_tri], edges[1][topo.leaf_tri]
    zero = topo.zero[:n + 1]
    rows = torch.cat([corners[:, 0], _bits(node_tri[n:]).unsqueeze(-1),
                      e1, zero, e2, zero], dim=-1)
    return PackedBVH(nodes=nodes, node_tri=node_tri, tri_verts=tri_verts,
                     n_internal=n, depth=depth,
                     inner_records=inner.view(n, 16), leaf_rows=rows,
                     topology=topo)


def child_ref(child, n_internal):
    """K2's reference to node ``child``: an internal node's own index, or
    ~k (= -1 - k) for leaf k, node ``n_internal + k``, whose triangle row
    is row k of ``leaf_rows``."""
    return torch.where(child < n_internal, child, n_internal - 1 - child)


def _check_rays(bvh: PackedBVH, o, d, tmax, active, stack=STACK_DEPTH):
    dev = o.device
    R = o.shape[0]
    _check_depth(bvh.depth, stack)
    n = bvh.n_internal
    native.check(bvh.nodes, "nodes", torch.float32, (2 * n + 1, 8), dev)
    native.check(bvh.node_tri, "node_tri", torch.int32, (2 * n + 1,), dev)
    native.check(bvh.tri_verts, "tri_verts", torch.float32, (None, 9), dev)
    native.check(bvh.inner_records, "inner_records", torch.float32, (n, 16),
                 dev)
    native.check(bvh.leaf_rows, "leaf_rows", torch.float32, (n + 1, 12), dev)
    native.check(o, "o", torch.float32, (R, 3), dev)
    native.check(d, "d", torch.float32, (R, 3), dev)
    native.check(tmax, "tmax", torch.float32, (R,), dev)
    native.check(active, "active", torch.bool, (R,), dev)
    return R


def intersect_any(bvh: PackedBVH, o, d, tmin: float, tmax, active,
                  width: int = 0):
    """Rays (R, 3) o, d; tmax (R,) f32; active (R,) bool → tri (R,) i32.
    ``width`` > 0 says the rays are an image's pixels, row-major, that
    many columns wide: the kernel then traces them in 8x4 pixel tiles,
    one a warp. The order changes no ray's result.

    CUDA tensors launch kernel K2, which replaces the TPU kernel
    trace_pallas._wide_direct_kernel (any-hit); CPU tensors take the
    plain version. The kernel reads ``bvh.inner_records`` (both children
    of a node in one 64 B record) and ``bvh.leaf_rows`` (a leaf's
    triangle, edges pre-subtracted), keeps the near child in a register
    and the far ones on a stack, and visits the nodes of the plain
    version in its order; on the card it is bound by instruction issue
    thinned by warp divergence; see csrc/trace.cu."""
    if o.device.type == "cpu":
        return intersect_any_plain(bvh, o, d, tmin, tmax, active)
    if o.device.type != "cuda":
        raise ValueError(f"intersect_any: unsupported device {o.device}")
    R = _check_rays(bvh, o, d, tmax, active)
    out = torch.empty((R,), dtype=torch.int32, device=o.device)
    KERNEL.launch("hr_trace_any", native.ptr(bvh.inner_records),
                  native.ptr(bvh.leaf_rows), bvh.n_internal,
                  native.ptr(o), native.ptr(d), native.ptr(tmax),
                  native.ptr(active), float(tmin), R, int(width),
                  native.ptr(out))
    return out


def intersect_closest(bvh: PackedBVH, o, d, tmin: float, tmax, active,
                      width: int = 0):
    """Rays (R, 3) o, d; tmax (R,) f32; active (R,) bool → (t, tri, u, v)
    of the nearest hit, each (R,), tri i32; ``width`` as for
    ``intersect_any``.

    CUDA tensors launch kernel K2c, which replaces the TPU kernel
    trace_pallas._wide_direct_kernel (closest-hit); CPU tensors take the
    plain version. The kernel is K2's traversal in closest-hit mode;
    see csrc/trace.cu."""
    if o.device.type == "cpu":
        return intersect_closest_plain(bvh, o, d, tmin, tmax, active)
    if o.device.type != "cuda":
        raise ValueError(f"intersect_closest: unsupported device {o.device}")
    R = _check_rays(bvh, o, d, tmax, active)
    t, u, v = (torch.empty((R,), dtype=torch.float32, device=o.device)
               for _ in range(3))
    tri = torch.empty((R,), dtype=torch.int32, device=o.device)
    KERNEL_CLOSEST.launch(
        "hr_trace_closest", native.ptr(bvh.inner_records),
        native.ptr(bvh.leaf_rows), bvh.n_internal, native.ptr(o),
        native.ptr(d), native.ptr(tmax), native.ptr(active), float(tmin), R,
        int(width), native.ptr(t), native.ptr(tri), native.ptr(u),
        native.ptr(v))
    return t, tri, u, v


def intersect_packet(bvh: PackedBVH, o, d, tmin: float, tmax, active,
                     any_hit: bool, width: int = 0):
    """Packet traversal of rays (R, 3) o, d; tmax (R,) f32; active (R,)
    bool → (t, tri, u, v), each (R,), as ``intersect_closest`` reports
    them; any-hit's tri is a triangle hit, or -1, and its t, u, v are
    those of that hit. A packet is 32 consecutive rays, or with
    ``width`` > 0, for an image's pixels in row-major order that many
    columns wide, one 8x4 pixel tile (``packet_lanes``).

    CUDA tensors launch kernel K2b, which replaces the TPU kernel
    trace_pallas._traverse_kernel; CPU tensors take the plain version.
    On the card a warp is a packet: one record load serves its 32 rays,
    the near child stays in a register and the warp's stack in registers
    across its lanes; see csrc/trace.cu."""
    if o.device.type == "cpu":
        return intersect_packet_plain(bvh, o, d, tmin, tmax, active, any_hit,
                                      width)
    if o.device.type != "cuda":
        raise ValueError(f"intersect_packet: unsupported device {o.device}")
    R = _check_rays(bvh, o, d, tmax, active, PACKET_STACK_DEPTH)
    t, u, v = (torch.empty((R,), dtype=torch.float32, device=o.device)
               for _ in range(3))
    tri = torch.empty((R,), dtype=torch.int32, device=o.device)
    KERNEL_PACKET.launch(
        "hr_trace_packet", native.ptr(bvh.inner_records),
        native.ptr(bvh.leaf_rows), bvh.n_internal, native.ptr(o),
        native.ptr(d), native.ptr(tmax), native.ptr(active), float(tmin), R,
        int(width), int(any_hit), native.ptr(t), native.ptr(tri),
        native.ptr(u), native.ptr(v))
    return t, tri, u, v


def packet_lanes(R, width, device):
    """K2b's packets of R rays → (P, 32) i64, the ray of each lane, -1
    for a dead lane: 32 consecutive rays; or, with ``width`` > 0, the
    8x4 pixel tiles of an image ``width`` columns wide, tiles row-major
    and lanes row-major inside a tile (the kernel's ray_of_thread);
    ragged edge tiles leave lanes dead."""
    if width <= 0:
        i = torch.arange(-(-R // PACKET) * PACKET, device=device)
        return torch.where(i < R, i, -1).view(-1, PACKET)
    tiles_x = -(-width // PACKET_TILE_W)
    tiles_y = -(-(-(-R // width)) // PACKET_TILE_H)
    k = torch.arange(tiles_x * tiles_y * PACKET, device=device)
    lane, tile = k % PACKET, torch.div(k, PACKET, rounding_mode="floor")
    x = tile % tiles_x * PACKET_TILE_W + lane % PACKET_TILE_W
    y = torch.div(tile, tiles_x, rounding_mode="floor") * PACKET_TILE_H \
        + torch.div(lane, PACKET_TILE_W, rounding_mode="floor")
    i = y * width + x
    return torch.where((x < width) & (i < R), i, -1).view(-1, PACKET)


def _warp_sum(x):
    """(P, 32) → (P,): the kernel's xor-butterfly sum, whose every lane
    ends with v[0] + v[16] first, then pairs of those at offset 8, ..."""
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return x[:, 0]


def intersect_packet_plain(bvh: PackedBVH, o, d, tmin: float, tmax, active,
                           any_hit: bool, width: int = 0, visits=None,
                           trail=None):
    """Plain PyTorch version of kernel K2b: all packets step together,
    one node per packet per step, with the kernel's packets
    (``packet_lanes``), votes, sums and visiting order; it walks the
    per-node layout and keeps both children on its stack. ``visits``, a
    dict, receives the number of internal and leaf nodes the packets
    visit; ``trail``, a list, each step's (P,) node of every packet (-1
    for a packet that is done)."""
    KERNEL_PACKET.note_plain(o)
    dev = o.device
    R = o.shape[0]
    ray = packet_lanes(R, width, dev)
    P = ray.shape[0]
    lane_ok = ray >= 0
    src = torch.clamp(ray, min=0)

    def lanes(x, fill):
        ok = lane_ok.view(P, PACKET, *([1] * (x.dim() - 1)))
        return torch.where(ok, x[src], torch.full_like(x[src], fill))

    # inactive and dead lanes take part in no vote and no hit
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

        if trail is not None:
            trail.append(torch.where(live, node, -1))
        is_leaf = node >= bvh.n_internal
        tri = bvh.node_tri[node]
        leaf = _leaf_rows(bvh, node).unsqueeze(1)
        hit, t, u, v = ray_triangle_edges(org, dirs, leaf[..., 0:3],
                                          leaf[..., 4:7], leaf[..., 8:11],
                                          tmin, best)
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
    t = torch.where(out < 0, torch.full_like(best, float("inf")), best)

    def flat(x):   # lanes → rays
        y = x.new_empty((R,))
        y[ray[lane_ok]] = x[lane_ok]
        return y

    return flat(t), flat(out), flat(bu), flat(bv)


def _leaf_rows(bvh: PackedBVH, node):
    """The kernels' leaf row (v0, e1, e2) of each node; a row of leaf 0
    for an internal node."""
    return bvh.leaf_rows[torch.clamp(node - bvh.n_internal, min=0)]


def ray_triangle(o, d, p0, p1, p2, tmin, tmax):
    """Möller–Trumbore, both-faced → (hit, t, u, v)."""
    return ray_triangle_edges(o, d, p0, p1 - p0, p2 - p0, tmin, tmax)


def ray_triangle_edges(o, d, p0, e1, e2, tmin, tmax):
    """``ray_triangle`` on the corner p0 and the edges e1 = p1 - p0,
    e2 = p2 - p0 (K2's leaf rows)."""
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
        leaf = _leaf_rows(bvh, node)
        hit, t, u, v = ray_triangle_edges(o, d, leaf[:, 0:3], leaf[:, 4:7],
                                          leaf[:, 8:11], tmin, best)
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


# ---------------------------------------------------------------------------
# K2w and K2m: wide-BVH packet traversals
# ---------------------------------------------------------------------------

def check_wide_stacks(wide, mimt: bool):
    """Raise if the tree is too deep for the kernel's internal-node stack.
    K2w keeps one compressed entry per level of the DFS path: a tree of
    depth D (super-root 0) needs D + 1 entries. K2m pushes up to 8 child
    ids and pops one per level: 7 D + 1."""
    need = 7 * wide.depth + 1 if mimt else wide.depth + 1
    if need > WIDE_STACK:
        raise ValueError(f"wide BVH of depth {wide.depth} needs "
                         f"{need} stack entries; the kernel has {WIDE_STACK}")


# the leaf clusters K2w is built for (csrc/trace.cu, one instantiation
# each); K2m takes the default 4 alone, as the reference's p8 layout
WIDE_LEAF_TRIS = (4, 8, 16)


def _check_wide(wide, o, d, tmax, active, mimt):
    dev = o.device
    R = o.shape[0]
    check_wide_stacks(wide, mimt)
    leaf_tris = wide.leaves_flat.shape[1] // 12
    if leaf_tris not in ((4,) if mimt else WIDE_LEAF_TRIS):
        raise ValueError(f"{'K2m' if mimt else 'K2w'}: no build for "
                         f"{leaf_tris}-triangle leaf clusters")
    native.check(wide.nodes_flat, "nodes_flat", torch.float32, (None, 48),
                 dev)
    native.check(wide.leaves_flat, "leaves_flat", torch.float32,
                 (None, 12 * leaf_tris), dev)
    native.check(wide.meta, "meta", torch.int32, (None, 2), dev)
    native.check(wide.deep_pushes, "deep_pushes", torch.int32, (1,), dev)
    native.check(o, "o", torch.float32, (R, 3), dev)
    native.check(d, "d", torch.float32, (R, 3), dev)
    native.check(tmax, "tmax", torch.float32, (R,), dev)
    native.check(active, "active", torch.bool, (R,), dev)
    return R, leaf_tris


def _launch_wide(kernel, entry, wide, o, d, tmin, tmax, active, any_hit):
    R, leaf_tris = _check_wide(wide, o, d, tmax, active,
                               entry == "hr_trace_mimt")
    t, u, v = (torch.empty((R,), dtype=torch.float32, device=o.device)
               for _ in range(3))
    tri = torch.empty((R,), dtype=torch.int32, device=o.device)
    # the kernels read the records as float4 (48- and 12 L-float rows)
    kernel.launch(entry, native.ptr(native.aligned(wide.nodes_flat)),
                  native.ptr(native.aligned(wide.leaves_flat)), leaf_tris,
                  native.ptr(wide.meta),
                  wide.nodes_flat.shape[0], wide.leaves_flat.shape[0],
                  wide.meta.shape[0], native.ptr(o), native.ptr(d),
                  native.ptr(tmax), native.ptr(active), float(tmin), R,
                  int(any_hit), native.ptr(t), native.ptr(tri),
                  native.ptr(u), native.ptr(v), native.ptr(wide.deep_pushes))
    return t, tri, u, v


def intersect_wide(wide, o, d, tmin: float, tmax, active, any_hit: bool):
    """Rays (R, 3) o, d; tmax (R,) f32; active (R,) bool → (t, tri, u, v)
    over the 8-wide tree ``wide`` (ops/bvh_wide.WideBVH), in packets of
    1024 consecutive rays that share one compressed stack per kind
    (internal nodes, leaf clusters): entries (parent << 8 | pending child
    mask), popped lowest slot first, one node and one cluster a step.

    CUDA tensors launch kernel K2w, which replaces the TPU kernel
    trace_pallas._wide_traverse_kernel; CPU tensors take the plain
    version. On the card a block runs a program of two packets, each on
    its own half of the block, 4 rays a thread; see csrc/trace.cu."""
    if o.device.type == "cpu":
        return intersect_wide_plain(wide, o, d, tmin, tmax, active, any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"intersect_wide: unsupported device {o.device}")
    return _launch_wide(KERNEL_WIDE, "hr_trace_wide", wide, o, d, tmin, tmax,
                        active, any_hit)


def intersect_mimt(wide, o, d, tmin: float, tmax, active, any_hit: bool):
    """As ``intersect_wide``, but each 128-ray row of a 1024-ray packet
    walks the tree on its own pair of stacks of direct node ids, pushing
    the children its rays hit in ascending slot order and popping the
    last pushed first.

    CUDA tensors launch kernel K2m, which replaces the TPU kernel
    trace_pallas._mimt_traverse_kernel; CPU tensors take the plain
    version. On the card a warp walks a row, 4 rays a lane; see
    csrc/trace.cu."""
    if o.device.type == "cpu":
        return intersect_mimt_plain(wide, o, d, tmin, tmax, active, any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"intersect_mimt: unsupported device {o.device}")
    return _launch_wide(KERNEL_MIMT, "hr_trace_mimt", wide, o, d, tmin, tmax,
                        active, any_hit)


def wide_kernel_info(mimt: bool, leaf_tris: int = 4) -> dict:
    """K2w's (for ``leaf_tris``-triangle clusters) or K2m's build as the
    card runs it: registers a thread, local memory bytes a thread (stack
    frame and spills), static shared memory bytes, threads a block and
    the blocks an SM holds."""
    if mimt:
        return _kernel_info(1)
    return _kernel_info({4: 0, 8: 3, 16: 4}[leaf_tris])


def packet_kernel_info() -> dict:
    """K2b's build as the card runs it, as ``wide_kernel_info``."""
    return _kernel_info(2)


def _kernel_info(which: int) -> dict:
    out = (ctypes.c_int * 5)()
    lib = native.kernel_library()
    rc = lib.hr_trace_info(which, out)
    if rc != 0:
        raise RuntimeError(f"hr_trace_info: CUDA error {rc} "
                           f"({lib.hr_error_string(rc).decode()})")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "threads",
                     "blocks_per_sm"), out))


_POP8 = torch.tensor([bin(i).count("1") for i in range(256)])


def _popcount8(x):
    return _POP8.to(x.device)[x & 255]


def _wide_packets(o, d, tmax, active):
    """Rays → (P, 1024, ...) packets, P even (a program is two packets):
    padding rays have o = 0, d = 1 and are inactive; an inactive ray
    carries tmax -1 and starts with the sentinel id, as the reference's
    ``intersect_wide`` gives them (trace_pallas.py:768-778)."""
    R = o.shape[0]
    pad = (-R) % (WIDE_PACKET * WIDE_PAIR)
    P = (R + pad) // WIDE_PACKET
    tm = torch.where(active, torch.clamp(tmax, max=PACKET_TMAX), -1.0)
    org = torch.cat([o, o.new_zeros((pad, 3))]).view(P, WIDE_PACKET, 3)
    dirs = torch.cat([d, d.new_ones((pad, 3))]).view(P, WIDE_PACKET, 3)
    tm = torch.cat([tm, tm.new_full((pad,), -1.0)]).view(P, WIDE_PACKET)
    return P, org, dirs, tm


def _leaf_visit(rec, ray, tmin, st):
    """The L Moller-Trumbore tests of one leaf cluster per packet (or
    row): ``rec`` (..., 12 L) record rows broadcast over the rays
    (..., n); the state's "t", "tri", "u", "v" are replaced where a hit
    has t <= the best so far (in triangle order)."""
    ox, oy, oz, dx, dy, dz = ray[:6]
    for k in range(rec.shape[-1] // 12):
        f = lambda j: rec[..., 12 * k + j].unsqueeze(-1)
        p0x, p0y, p0z = f(0), f(1), f(2)
        a1x, a1y, a1z = f(3), f(4), f(5)
        a2x, a2y, a2z = f(6), f(7), f(8)
        tid = f(9)
        pvx = dy * a2z - dz * a2y
        pvy = dz * a2x - dx * a2z
        pvz = dx * a2y - dy * a2x
        det = a1x * pvx + a1y * pvy + a1z * pvz
        inv_det = 1.0 / torch.where(torch.abs(det) < TRI_EPS, TRI_EPS, det)
        tvx = ox - p0x
        tvy = oy - p0y
        tvz = oz - p0z
        uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
        qvx = tvy * a1z - tvz * a1y
        qvy = tvz * a1x - tvx * a1z
        qvz = tvx * a1y - tvy * a1x
        vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det
        tt = (a2x * qvx + a2y * qvy + a2z * qvz) * inv_det
        hit = ((torch.abs(det) >= TRI_EPS) & (uu >= 0.0) & (vv >= 0.0)
               & (uu + vv <= 1.0) & (tt >= tmin) & (tt <= st["t"])
               & (tid >= 0.0))
        st["t"] = torch.where(hit, tt, st["t"])
        st["tri"] = torch.where(hit, tid.to(torch.int32), st["tri"])
        st["u"] = torch.where(hit, uu, st["u"])
        st["v"] = torch.where(hit, vv, st["v"])


def _node_votes(rec, ray, tmin, st, any_hit):
    """The 8 slab tests of one wide node per packet (or row) → the mask
    of child slots hit by any of its rays (..., ) int64. Any-hit rays
    that have a hit test against -inf and vote for nothing."""
    ox, oy, oz = ray[0:3]
    ix, iy, iz = ray[6:9]
    tb = st["t"]
    if any_hit:
        tb = torch.where(st["tri"] < 0, st["t"], float("-inf"))
    hm = 0
    for c in range(8):
        f = lambda j: rec[..., 6 * c + j].unsqueeze(-1)
        t0x = (f(0) - ox) * ix
        t1x = (f(3) - ox) * ix
        t0y = (f(1) - oy) * iy
        t1y = (f(4) - oy) * iy
        t0z = (f(2) - oz) * iz
        t1z = (f(5) - oz) * iz
        tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                         torch.minimum(t0y, t1y)),
                           torch.minimum(t0z, t1z))
        tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                         torch.maximum(t0y, t1y)),
                           torch.maximum(t0z, t1z))
        ok = (tn <= tf) & (tf >= tmin) & (tn <= tb)
        hm = hm | (ok.any(dim=-1).long() << c)
    return hm


def _ray_planes(org, dirs):
    """(..., 3) rays → [ox, oy, oz, dx, dy, dz, ix, iy, iz] planes."""
    tiny = torch.where(dirs < 0, -1e-12, 1e-12)
    inv = 1.0 / torch.where(torch.abs(dirs) < 1e-12, tiny, dirs)
    return [x[..., a] for x in (org, dirs, inv) for a in range(3)]


def _wide_traverse_plain(wide, o, d, tmin, tmax, active, any_hit, mimt,
                         visits):
    """Both wide kernels' plain version: the live programs step together,
    ``WIDE_CHUNK`` steps between liveness tests; a program (two packets)
    runs while either packet has stack entries and, any-hit, a ray
    without a hit, so a finished packet keeps popping beside its live
    sibling, as in the reference."""
    if wide.width != 8:
        raise ValueError(f"K2w / K2m walk 8-wide trees, not {wide.width}-"
                         f"wide")
    if mimt and wide.leaf_tris != 4:
        raise ValueError(f"K2m: no build for {wide.leaf_tris}-triangle leaf "
                         f"clusters")
    dev = o.device
    P, org, dirs, tm = _wide_packets(o, d, tmax, active)
    ray = _ray_planes(org, dirs)
    if mimt:   # (P, rows, 128): each row a traversal of its own
        ray = [x.view(P, WIDE_ROWS, -1) for x in ray]
        tm = tm.view(P, WIDE_ROWS, -1)
    lead = (P, WIDE_ROWS) if mimt else (P,)
    st = dict(istack=torch.zeros((*lead, WIDE_STACK), dtype=torch.long,
                                 device=dev),
              lstack=torch.zeros((*lead, WIDE_LEAF_STACK), dtype=torch.long,
                                 device=dev),
              isp=torch.ones(lead, dtype=torch.long, device=dev),
              lsp=torch.zeros(lead, dtype=torch.long, device=dev),
              t=tm.clone(),
              tri=torch.where(tm < 0, INACTIVE_TRI, -1).to(torch.int32),
              u=torch.zeros_like(tm), v=torch.zeros_like(tm))
    # K2w's bootstrap entry (super-root 0, mask 1) decodes to the root;
    # K2m's rows start on the super-root's id 0
    if not mimt:
        st["istack"][:, 0] = 1
    steps = torch.zeros((P // WIDE_PAIR,), dtype=torch.long, device=dev)
    meta = wide.meta.long()
    # node visits, leaf visits, leaf pushes past the reference's 128,
    # packet (row) steps
    count = torch.zeros(4, dtype=torch.long, device=dev)
    step = _mimt_step if mimt else _wide_step
    while True:
        live = (st["isp"] > 0) | (st["lsp"] > 0)
        if mimt:
            live = live.any(dim=1)
        if any_hit:
            live = live & ~(st["tri"] >= 0).reshape(P, -1).all(dim=1)
        prog = live.view(-1, WIDE_PAIR).any(dim=1) & (steps < WIDE_MAX_STEPS)
        if not bool(prog.any()):
            break
        steps = steps + WIDE_CHUNK * prog.long()
        pk = torch.nonzero(prog.repeat_interleave(WIDE_PAIR)).squeeze(1)
        sub = {k: x[pk] for k, x in st.items()}
        sray = [x[pk] for x in ray]
        for _ in range(WIDE_CHUNK):
            step(wide, meta, sub, sray, tmin, any_hit, count)
        for k, x in st.items():
            x[pk] = sub[k]
    wide.deep_pushes += count[2].to(wide.deep_pushes.dtype)
    if visits is not None:
        # the packet (row) steps that popped nothing of a kind
        for key, n in (("internal", int(count[0])), ("leaf", int(count[1])),
                       ("steps", int(steps.sum())),
                       ("idle_internal", int(count[3] - count[0])),
                       ("idle_leaf", int(count[3] - count[1]))):
            visits[key] = visits.get(key, 0) + n
    t, tri, u, v = (st[k].reshape(-1)[:o.shape[0]]
                    for k in ("t", "tri", "u", "v"))
    return torch.where(tri < 0, float("inf"), t), tri, u, v


def _take(stack, pos):
    """stack[..., pos] for (...) positions, 0 past the end (the
    reference's one-hot lane read)."""
    slot = torch.clamp(pos, max=stack.shape[-1] - 1).unsqueeze(-1)
    return torch.where(pos < stack.shape[-1],
                       stack.gather(-1, slot).squeeze(-1), 0)


def _put(stack, pos, val, where):
    """stack[..., pos] = val where ``where`` and pos is in range."""
    ok = where & (pos < stack.shape[-1])
    slot = torch.clamp(pos, max=stack.shape[-1] - 1).unsqueeze(-1)
    stack.scatter_(-1, slot, torch.where(ok.unsqueeze(-1), val.unsqueeze(-1),
                                         stack.gather(-1, slot)))


def _wide_step(wide, meta, st, ray, tmin, any_hit, count):
    """One K2w step of every packet in ``st`` (updated in place); adds
    the node and leaf visits, the deep leaf pushes and the packet steps
    to ``count``."""
    n_meta = meta.shape[0]

    def pop(kind, col, enabled):
        """Pop the top compressed entry: its lowest pending child →
        (child id, valid); the entry loses that bit and leaves the stack
        with its last one."""
        stack, sp = st[kind + "stack"], st[kind + "sp"]
        top = torch.clamp(sp - 1, min=0)
        e = _take(stack, top)
        valid = (sp > 0) & enabled
        par, bits = e >> 8, e & 255
        below = (bits & -bits) - 1
        m = meta[torch.clamp(par, max=n_meta - 1), col]
        child = (m >> 8) + _popcount8((m & 255) & below)
        rem = bits & (bits - 1)
        _put(stack, top, (par << 8) | rem, valid)
        st[kind + "sp"] = sp - ((rem == 0) & valid).long()
        return child, valid

    # a packet whose leaf stack is full pops no node this step
    child_i, ivalid = pop("i", 0, st["lsp"] < WIDE_LEAF_STACK)
    child_l, lvalid = pop("l", 1, torch.ones_like(ivalid))
    i = torch.clamp(torch.where(ivalid, child_i, 0),
                    max=wide.nodes_flat.shape[0] - 1)
    dummy = wide.leaves_flat.shape[0] - 1
    k = torch.where(lvalid, torch.clamp(child_l, max=dummy), dummy)
    _leaf_visit(wide.leaves_flat[k], ray, tmin, st)
    hm = _node_votes(wide.nodes_flat[i], ray, tmin, st, any_hit)
    hm = hm * ivalid.long()
    mi = meta[torch.clamp(i, max=n_meta - 1)]
    deep = torch.zeros_like(count[2])
    for kind, col in (("i", 0), ("l", 1)):
        # one entry (node, the slots of this kind its rays hit)
        h = hm & mi[:, col] & 255
        sp = st[kind + "sp"]
        push = h != 0
        _put(st[kind + "stack"], sp, (i << 8) | h, push)
        if kind == "l":
            deep = (push & (sp >= WIDE_STACK)).sum()
        st[kind + "sp"] = sp + push.long()
    count += torch.stack([ivalid.sum(), lvalid.sum(), deep,
                          count.new_tensor(ivalid.numel())])


def _mimt_step(wide, meta, st, ray, tmin, any_hit, count):
    """One K2m step of every row of every packet in ``st`` (updated in
    place); adds the node and leaf visits (one a row step), the deep
    leaf pushes and the row steps to ``count``."""
    n_meta = meta.shape[0]

    def pop(kind, enabled):
        """Pop the top node id → (id, valid)."""
        sp = st[kind + "sp"]
        valid = (sp > 0) & enabled
        child = _take(st[kind + "stack"], torch.clamp(sp - 1, min=0))
        st[kind + "sp"] = torch.where(valid, sp - 1, sp)
        return child, valid

    # a row whose leaf stack could overflow pops no node this step
    child_i, ivalid = pop("i", st["lsp"] <= WIDE_LEAF_STACK - 8)
    child_l, lvalid = pop("l", torch.ones_like(ivalid))
    dummy_n = wide.nodes_flat.shape[0] - 1
    dummy_l = wide.leaves_flat.shape[0] - 1
    ki = torch.where(ivalid, torch.clamp(child_i, max=dummy_n), dummy_n)
    kl = torch.where(lvalid, torch.clamp(child_l, max=dummy_l), dummy_l)
    _leaf_visit(wide.leaves_flat[kl], ray, tmin, st)
    hm = _node_votes(wide.nodes_flat[ki], ray, tmin, st, any_hit)
    hm = hm * ivalid.long()
    mi = meta[torch.clamp(ki, max=n_meta - 1)]
    deep = torch.zeros_like(count[2])
    for kind, col in (("i", 0), ("l", 1)):
        # each child of this kind the row's rays hit, in slot order: its
        # id ranks in the kind's mask from the base
        base, full = mi[..., col] >> 8, mi[..., col] & 255
        h = hm & full
        sp = st[kind + "sp"]
        for c in range(8):
            below = (1 << c) - 1
            has = (h >> c) & 1 == 1
            pos = sp + _popcount8(h & below)
            _put(st[kind + "stack"], pos, base + _popcount8(full & below),
                 has)
            if kind == "l":
                deep = deep + (has & (pos >= WIDE_STACK)).sum()
        st[kind + "sp"] = sp + _popcount8(h)
    count += torch.stack([ivalid.sum(), lvalid.sum(), deep,
                          count.new_tensor(ivalid.numel())])


def intersect_wide_plain(wide, o, d, tmin: float, tmax, active,
                         any_hit: bool, visits=None):
    """Plain PyTorch version of kernel K2w; ``visits``, a dict, receives
    the number of node and leaf-cluster visits (one each a packet step),
    the steps the programs ran ("steps", a multiple of 16 each) and the
    packet steps that popped no node ("idle_internal") or no leaf
    cluster ("idle_leaf")."""
    KERNEL_WIDE.note_plain(o)
    return _wide_traverse_plain(wide, o, d, tmin, tmax, active, any_hit,
                                False, visits)


def intersect_mimt_plain(wide, o, d, tmin: float, tmax, active,
                         any_hit: bool, visits=None):
    """Plain PyTorch version of kernel K2m; ``visits`` as for K2w, with
    row steps in place of packet steps."""
    KERNEL_MIMT.note_plain(o)
    return _wide_traverse_plain(wide, o, d, tmin, tmax, active, any_hit,
                                True, visits)
