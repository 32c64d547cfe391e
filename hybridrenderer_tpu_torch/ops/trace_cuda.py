"""Any-hit BVH traversal: kernel K2 and its plain version
(hybridrenderer_tpu/ops/trace_pallas.py in any-hit mode; the plain
version follows ops/trace.py intersect_bvh).

``pack_bvh`` lays the binary BVH out for the kernel: per node two float4
(min xyz + left child id bits, max xyz + right child id bits), the leaf
triangle ids, and the triangle corners as (T, 9) floats.
``intersect_any`` returns, per ray, the id of a triangle hit with
tmin <= t <= tmax, or -1.
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
KERNEL = native.KERNELS["trace_any"]


@dataclasses.dataclass
class PackedBVH:
    nodes: Any       # (N, 8) f32: min xyz, left bits, max xyz, right bits
    node_tri: Any    # (N,) i32 triangle id of leaves, -1 internal
    tri_verts: Any   # (T, 9) f32 triangle corners
    n_internal: int


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


def pack_bvh(bvh, v0, v1, v2) -> PackedBVH:
    """Raises if the tree is too deep for the traversal's stack: popping
    a node at depth k leaves at most k entries, and its two children make
    k + 2, so a tree of depth D needs D + 1 entries. Within that bound
    neither the kernel nor its plain version ever drops a child."""
    depth = tree_depth(bvh.left, bvh.right)
    if depth + 1 > STACK_DEPTH:
        raise ValueError(f"BVH of depth {depth} needs a traversal stack of "
                         f"{depth + 1} entries; the kernel has {STACK_DEPTH}")
    bits = lambda x: x.to(torch.int32).view(torch.float32).unsqueeze(-1)
    nodes = torch.cat([bvh.node_min, bits(bvh.left), bvh.node_max,
                       bits(bvh.right)], dim=-1).contiguous()
    return PackedBVH(nodes=nodes, node_tri=bvh.tri.to(torch.int32).contiguous(),
                     tri_verts=torch.cat([v0, v1, v2], -1).contiguous(),
                     n_internal=bvh.num_tris - 1)


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
    dev = o.device
    R = o.shape[0]
    native.check(bvh.nodes, "nodes", torch.float32, (None, 8), dev)
    native.check(bvh.node_tri, "node_tri", torch.int32, (None,), dev)
    native.check(bvh.tri_verts, "tri_verts", torch.float32, (None, 9), dev)
    native.check(o, "o", torch.float32, (R, 3), dev)
    native.check(d, "d", torch.float32, (R, 3), dev)
    native.check(tmax, "tmax", torch.float32, (R,), dev)
    native.check(active, "active", torch.bool, (R,), dev)
    out = torch.empty((R,), dtype=torch.int32, device=dev)
    KERNEL.launch("hr_trace_any", native.ptr(bvh.nodes),
                  native.ptr(bvh.node_tri), native.ptr(bvh.tri_verts),
                  bvh.n_internal, native.ptr(o), native.ptr(d),
                  native.ptr(tmax), native.ptr(active), float(tmin), R,
                  native.ptr(out))
    return out


def ray_triangle(o, d, p0, p1, p2, tmin, tmax):
    """Möller–Trumbore, both-faced → (hit, t)."""
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
    return hit, t


def ray_aabb(o, inv_d, bmin, bmax, tmin, tmax):
    """Slab test → (hit, entry distance)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    return (tn <= tf) & (tf >= tmin) & (tn <= tmax), tn


def intersect_any_plain(bvh: PackedBVH, o, d, tmin: float, tmax, active):
    """Plain PyTorch version of kernel K2: every ray keeps its own stack
    and all rays step together, one node per ray per step, in the
    kernel's visiting order."""
    KERNEL.note_plain(o)
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
    out = torch.full((R,), -1, dtype=torch.int32, device=dev)
    while bool((sp > 0).any()):
        live = sp > 0
        sp = torch.where(live, sp - 1, sp)
        node = torch.where(live, stack[rows, torch.clamp(sp, min=0)], 0)

        is_leaf = node >= bvh.n_internal
        tri = bvh.node_tri[node]
        safe = torch.clamp(tri, 0, T - 1).long()
        hit, _ = ray_triangle(o, d, tv[safe, 0:3], tv[safe, 3:6],
                              tv[safe, 6:9], tmin, tmax)
        take = live & is_leaf & hit & (tri >= 0)
        out = torch.where(take, tri, out)
        sp = torch.where(take, 0, sp)

        inner = live & ~is_leaf
        left = torch.where(inner, left_of[node], 0)
        right = torch.where(inner, right_of[node], 0)
        lhit, lt = ray_aabb(o, inv_d, node_min[left], node_max[left], tmin,
                            tmax)
        rhit, rt = ray_aabb(o, inv_d, node_min[right], node_max[right], tmin,
                            tmax)
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
    return out
