"""Binary BVH over the world-space triangle soup
(hybridrenderer_tpu/ops/bvh.py): the binned-SAH host build of
native/bvh_builder.cpp, loaded through ctypes (native.bvh_library), and
the frozen-topology refit of dynamic scenes.

Node indexing for T triangles: internal nodes 0 .. T-2 (root 0), leaf k
= node (T-1)+k holding one triangle.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Any

import numpy as np
import torch

from .. import native


@dataclasses.dataclass
class BVH:
    node_min: Any   # (2T-1, 3) f32
    node_max: Any   # (2T-1, 3) f32
    left: Any       # (2T-1,) i32 child node id, -1 for leaves
    right: Any      # (2T-1,) i32
    tri: Any        # (2T-1,) i32 triangle id for leaves, -1 internal
    num_tris: int


def build_sah(v0, v1, v2, device=None) -> BVH:
    """(T, 3) world-space triangle corners → binned-SAH BVH on
    ``device`` (default: the corners' device). The build runs on the
    host; a failed build raises."""
    device = v0.device if device is None else torch.device(device)
    a0, a1, a2 = (np.ascontiguousarray(v.detach().cpu().numpy(), np.float32)
                  for v in (v0, v1, v2))
    T = a0.shape[0]
    if T == 0:
        raise ValueError("cannot build a BVH over zero triangles")
    N = 2 * T - 1
    nmin = np.empty((N, 3), np.float32)
    nmax = np.empty((N, 3), np.float32)
    left = np.empty((N,), np.int32)
    right = np.empty((N,), np.int32)
    tri = np.empty((N,), np.int32)

    def p(x, t):
        return x.ctypes.data_as(ctypes.POINTER(t))

    f, i = ctypes.c_float, ctypes.c_int32
    rc = native.bvh_library().hrtpu_build_sah(
        p(a0, f), p(a1, f), p(a2, f), T, p(nmin, f), p(nmax, f),
        p(left, i), p(right, i), p(tri, i))
    if rc != 0:
        raise RuntimeError(f"hrtpu_build_sah failed with code {rc}")
    return BVH(*(torch.from_numpy(x).to(device)
                 for x in (nmin, nmax, left, right, tri)), num_tris=T)


def refit_levels(bvh: BVH) -> list:
    """The internal nodes grouped by height above the leaves (host, once
    per topology), as (nodes, their left children, their right
    children) index tensors on the tree's device: group k holds the
    nodes whose children all lie in groups before it or are leaves, so a
    refit can take the groups in order, one gather-min pass each.
    ``len(groups)`` is the tree's height in internal-node levels (the
    reference's ``tree_height``)."""
    T = bvh.num_tris
    if T <= 1:
        return []
    lf = bvh.left[: T - 1].cpu().numpy().astype(np.int64)
    rt = bvh.right[: T - 1].cpu().numpy().astype(np.int64)
    done = np.zeros(T - 1, bool)
    groups = []
    while not done.all():
        ready = ~done & (np.where(lf < T - 1, done[np.minimum(lf, T - 2)],
                                  True)
                         & np.where(rt < T - 1, done[np.minimum(rt, T - 2)],
                                    True))
        idx = np.flatnonzero(ready)
        done[idx] = True
        groups.append(tuple(torch.from_numpy(x).to(bvh.left.device)
                            for x in (idx, lf[idx], rt[idx])))
    return groups


def refit_bvh(bvh: BVH, v0, v1, v2, levels) -> BVH:
    """Frozen-topology box refit after the triangles moved (the
    reference's refit_bvh / refit_bvh_rmq, bit for bit: both take exact
    min / max unions over the same leaf sets). ``levels`` comes from
    ``refit_levels``; the refit runs on the tree's device with no host
    work, one gather-min pass per level."""
    T = v0.shape[0]
    lt = bvh.tri[T - 1:].long() if T > 1 else bvh.tri[:1].long()
    sv0, sv1, sv2 = v0[lt], v1[lt], v2[lt]
    leaf_min = torch.minimum(torch.minimum(sv0, sv1), sv2)
    leaf_max = torch.maximum(torch.maximum(sv0, sv1), sv2)
    if T <= 1:
        return dataclasses.replace(bvh, node_min=leaf_min, node_max=leaf_max)
    # [min, -max]: one minimum per level takes both unions
    box = torch.cat([torch.full((T - 1, 6), float("inf"), device=v0.device),
                     torch.cat([leaf_min, -leaf_max], dim=-1)])
    for g, lg, rg in levels:
        box[g] = torch.minimum(box[lg], box[rg])
    return dataclasses.replace(bvh, node_min=box[:, :3].contiguous(),
                               node_max=(-box[:, 3:]).contiguous())
