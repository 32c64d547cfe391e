"""8-wide BVH with 4-triangle leaf clusters (hybridrenderer_tpu/ops/
bvh_wide.py): the collapse of the binary SAH tree that the wide
traversals K2w and K2m walk, and its refit for dynamic scenes.

The build is the reference's host numpy, copied (the JAX module imports
jax), so both packages give identical records from the same binary tree.
The port keeps the reference's FLAT records and none of its TPU tile
layouts (``nodes`` / ``leaves`` (T, 48, 128), ``pack_p8``,
``pack_meta_tiles``):

* ``nodes_flat`` (Tn*128, 48) f32: row s is wide node s, child slot c's
  box at columns 6c..6c+5 (min xyz, max xyz); empty slots carry inverted
  boxes (+-3e38), which pass the slab test, so only the meta masks
  exclude them. Row 0 is a synthetic super-root whose one internal child
  (slot 0) is the real root.
* ``leaves_flat`` (Tl*128, 48) f32: row k is leaf cluster k, triangle t
  at columns 12t..12t+11: v0, e1 = v1 - v0, e2 = v2 - v0, the triangle
  id as a float, two zeros; a missing triangle is all zeros with id -1.
  The last row is always padding (ids -1): the kernels' dummy leaf.
* ``meta`` (Nw, 2) i32: [ibase*256 | imask, lbase*256 | lmask] per wide
  node; the internal (leaf) children of a node are the ``imask``
  (``lmask``) slots, numbered from ``ibase`` (``lbase``) in slot order.
* ``slot_child_bin`` (Tn*128, 8) i32, ``cluster_tri`` (Tl*128, 4) i32:
  the binary node behind each slot and the triangle behind each cluster
  entry (-1 for none), the maps of ``refit_wide``.

``quantize_bf16`` (the reference's bf16 records, used only when the f32
records exceed its 96 MiB VMEM budget) is not ported: SceneTracer raises
there instead (ops/trace.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

WIDTH = 8
LEAF_TRIS = 4
_LEVELS = 3  # collapse depth: 2^3 = WIDTH


@dataclasses.dataclass
class WideBVH:
    nodes_flat: Any      # (Tn*128, 48) f32
    leaves_flat: Any     # (Tl*128, 48) f32
    meta: Any            # (Nw, 2) i32
    slot_child_bin: Any  # (Tn*128, 8) i32
    cluster_tri: Any     # (Tl*128, 4) i32
    num_wide: int        # Nw, the super-root included
    num_clusters: int
    # depth of the deepest wide node (super-root 0, the real root 1),
    # which bounds the kernels' internal-node stacks
    depth: int
    # (1,) i32: leaf-stack pushes the wide traversals made past 128
    # entries, which the reference's kernels drop (ops/trace_cuda.py
    # WIDE_LEAF_STACK); a refit keeps the counter
    deep_pushes: Any = None

    @property
    def vmem_bytes(self) -> int:
        """The f32 records' size, the reference's VMEM-budget measure."""
        return 4 * (self.nodes_flat.numel() + self.leaves_flat.numel())


def _depths(parent: np.ndarray) -> np.ndarray:
    d = np.zeros(parent.shape[0], np.int32)
    for _ in range(96):
        nd = np.where(parent >= 0, d[np.maximum(parent, 0)] + 1, 0)
        if (nd == d).all():
            return d
        d = nd
    raise ValueError("BVH deeper than 96 levels")


def first_of_kind(parents: np.ndarray, kind: np.ndarray) -> np.ndarray:
    """True at the first entry of each parent group restricted to
    ``kind`` (parents must be group-sorted)."""
    out = np.zeros(len(parents), bool)
    idx = np.flatnonzero(kind)
    p = parents[idx]
    f = np.ones(len(p), bool)
    f[1:] = p[1:] != p[:-1]
    out[idx[f]] = True
    return out


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def build_wide(bvh, tri_v0, tri_v1, tri_v2, device=None) -> WideBVH:
    """Binary BVH (ops/bvh.BVH) + world triangles → WideBVH on ``device``
    (default: the triangles' device). Host numpy, once per topology.

    Collapse rules (the reference's): a binary node whose subtree holds
    at most 4 triangles becomes one leaf cluster (its triangles are a
    contiguous range of the sorted leaf order, which both builders
    give); the other nodes at binary depth 0 mod 3 become wide nodes,
    the children of a wide node being the clusters and wide nodes whose
    nearest mod-3 ancestor it is (at most 8). Children are ordered by
    their leaf-range start, internal and leaf children each numbered
    contiguously."""
    if device is None:
        device = tri_v0.device if isinstance(tri_v0, torch.Tensor) \
            else "cpu"
    width, levels, leaf_tris = WIDTH, _LEVELS, LEAF_TRIS
    nmin = _np(bvh.node_min)
    nmax = _np(bvh.node_max)
    left = _np(bvh.left)
    right = _np(bvh.right)
    tri = _np(bvh.tri)
    v0 = _np(tri_v0)
    v1 = _np(tri_v1)
    v2 = _np(tri_v2)
    T = max(int(bvh.num_tris), 1)
    N = nmin.shape[0]

    # parents + depths + subtree ranges/counts
    parent = np.full(N, -1, np.int32)
    if T > 1:
        ii = np.arange(T - 1)
        parent[left[: T - 1]] = ii
        parent[right[: T - 1]] = ii
    depth = _depths(parent)

    lo = np.zeros(N, np.int64)
    hi = np.zeros(N, np.int64)
    if T > 1:
        lo[T - 1:] = np.arange(T)
        hi[T - 1:] = np.arange(T)
        lo[: T - 1] = -1
        hi[: T - 1] = -1
        for _ in range(96):
            l_ok = lo[left[: T - 1]] >= 0
            r_ok = lo[right[: T - 1]] >= 0
            both = l_ok & r_ok
            nlo = np.where(both, np.minimum(lo[left[: T - 1]],
                                            lo[right[: T - 1]]), lo[: T - 1])
            nhi = np.where(both, np.maximum(hi[left[: T - 1]],
                                            hi[right[: T - 1]]), hi[: T - 1])
            if (nlo == lo[: T - 1]).all() and (nhi == hi[: T - 1]).all():
                break
            lo[: T - 1] = nlo
            hi[: T - 1] = nhi
    cnt = (hi - lo + 1).astype(np.int64)

    small = cnt <= leaf_tris
    if T == 1 or small[0]:
        # whole scene is one cluster: single wide node, one leaf child
        cluster_nodes = np.array([0], np.int64)
        cluster_parent_w = np.array([0], np.int64)
        cluster_lo = np.array([lo[0] if T > 1 else 0], np.int64)
        wide_nodes = np.array([0], np.int64)
        n_wide = 1
        wparent = np.array([-1], np.int64)
        wlo = np.array([0], np.int64)
    else:
        psmall = np.zeros(N, bool)
        psmall[parent >= 0] = small[np.maximum(parent, 0)][parent >= 0]
        cluster_root = small & ~psmall & (np.arange(N) != 0)
        is_wide = (~small) & (depth % levels == 0)

        # nearest mod-`levels` ancestor: ((depth-1) % levels) + 1 hops
        def ancestor_k(nodes, k):
            hops = [nodes]
            for _ in range(levels):
                prev = hops[-1]
                hops.append(np.where(prev >= 0,
                                     parent[np.maximum(prev, 0)], -1))
            return np.select([k == j for j in range(1, levels + 1)],
                             hops[1:levels + 1], -1)

        def enclosing(nodes):
            k = ((depth[nodes] - 1) % levels) + 1
            return ancestor_k(nodes, k)

        wide_nodes = np.flatnonzero(is_wide)
        cluster_nodes = np.flatnonzero(cluster_root)
        w_enc = enclosing(wide_nodes)       # binary id of enclosing wide node
        c_enc = enclosing(cluster_nodes)

        # assign wide indices level by level so children are contiguous
        bin2w = np.full(N, -1, np.int64)
        bin2w[0] = 0
        level = depth[wide_nodes] // levels
        n_wide = len(wide_nodes)
        for lv in range(1, int(level.max()) + 1 if n_wide > 1 else 1):
            sel = level == lv
            if not sel.any():
                continue
            nodes_lv = wide_nodes[sel]
            pw = bin2w[w_enc[sel]]
            if not (pw >= 0).all():
                raise ValueError("wide build: parent level not yet assigned")
            order = np.lexsort((lo[nodes_lv], pw))
            base = (bin2w >= 0).sum()
            bin2w[nodes_lv[order]] = base + np.arange(len(nodes_lv))
        wparent = np.full(n_wide, -1, np.int64)
        ww = bin2w[wide_nodes]
        wparent[ww[depth[wide_nodes] > 0]] = bin2w[w_enc][depth[wide_nodes] > 0]
        cluster_parent_w = bin2w[c_enc]
        if not (cluster_parent_w >= 0).all():
            raise ValueError("wide build: a cluster has no wide parent")
        # re-index arrays to wide order
        inv = np.empty(n_wide, np.int64)
        inv[ww] = np.arange(n_wide)
        wide_nodes = wide_nodes[inv]          # wide idx → binary id
        wlo = lo[wide_nodes]
        cluster_lo = lo[cluster_nodes]

    # order leaf clusters by (parent wide idx, range start) → contiguous
    corder = np.lexsort((cluster_lo, cluster_parent_w))
    cluster_nodes = cluster_nodes[corder]
    cluster_parent_w = cluster_parent_w[corder]
    cluster_lo = cluster_lo[corder]
    n_cluster = len(cluster_nodes)

    # wide index 0 is the synthetic super-root whose single internal
    # child is the real root (all other indices shift by +1)
    n_total = n_wide + 1
    Tn = (n_total + 127) // 128
    node_rec = np.zeros((Tn * 128, 6 * width), np.float32)
    # inverted boxes for empty slots
    for c in range(width):
        node_rec[:, 6 * c:6 * c + 3] = 3e38
        node_rec[:, 6 * c + 3:6 * c + 6] = -3e38

    # children (internal + leaf) per parent, ordered by lo; row 0 = the
    # super-root → root edge
    child_parent = np.concatenate([
        np.zeros(1, np.int64),
        wparent[1:] + 1 if n_wide > 1 else np.empty(0, np.int64),
        cluster_parent_w + 1,
    ])
    child_entity = np.concatenate([
        np.ones(1, np.int64),
        np.arange(1, n_wide) + 1 if n_wide > 1 else np.empty(0, np.int64),
        np.arange(n_cluster),
    ])
    child_is_leaf = np.concatenate([
        np.zeros(1, bool),
        np.zeros(max(n_wide - 1, 0), bool),
        np.ones(n_cluster, bool),
    ])
    child_lo = np.concatenate([
        np.full(1, -1, np.int64),
        wlo[1:] if n_wide > 1 else np.empty(0, np.int64),
        cluster_lo,
    ])
    child_bin = np.concatenate([
        wide_nodes[:1],
        wide_nodes[1:] if n_wide > 1 else np.empty(0, np.int64),
        cluster_nodes,
    ])
    order = np.lexsort((child_lo, child_parent))
    child_parent = child_parent[order]
    child_entity = child_entity[order]
    child_is_leaf = child_is_leaf[order]
    child_bin = child_bin[order]
    # slot index within parent
    first = np.ones(len(child_parent), bool)
    first[1:] = child_parent[1:] != child_parent[:-1]
    gidx = np.arange(len(child_parent))
    start = np.maximum.accumulate(np.where(first, gidx, 0))
    slot = gidx - start
    if not (slot < width).all():
        raise ValueError(f"wide build: a node with > {width} children")

    # masks + bases
    imask = np.zeros(n_total, np.int64)
    lmask = np.zeros(n_total, np.int64)
    ibase = np.zeros(n_total, np.int64)
    lbase = np.zeros(n_total, np.int64)
    np.add.at(imask, child_parent[~child_is_leaf], 1 << slot[~child_is_leaf])
    np.add.at(lmask, child_parent[child_is_leaf], 1 << slot[child_is_leaf])
    ifirst = first_of_kind(child_parent, ~child_is_leaf)
    lfirst = first_of_kind(child_parent, child_is_leaf)
    ibase[child_parent[ifirst]] = child_entity[ifirst]
    lbase[child_parent[lfirst]] = child_entity[lfirst]
    meta = np.stack([ibase * 256 + imask, lbase * 256 + lmask], axis=-1)
    if not (meta >> 8 < 2 ** 23).all():
        raise ValueError("wide build: a child base exceeds 2^23")

    # AABB records
    bmin = nmin[child_bin]
    bmax = nmax[child_bin]
    for ax in range(3):
        node_rec[child_parent, slot * 6 + ax] = bmin[:, ax]
        node_rec[child_parent, slot * 6 + 3 + ax] = bmax[:, ax]

    # leaf records; always >= 1 padded row, the kernels' dummy leaf
    Tl = n_cluster // 128 + 1
    leaf_rec = np.zeros((Tl * 128, 12 * leaf_tris), np.float32)
    cluster_tri = np.full((Tl * 128, leaf_tris), -1, np.int32)
    for t in range(leaf_tris):
        leaf_rec[:, 12 * t + 9] = -1.0  # id columns: padding = miss
    # sorted-leaf order → original tri ids
    sorted_tri = tri[T - 1:] if T > 1 else tri[:1]
    c_hi = hi[cluster_nodes] if T > 1 else np.array([0], np.int64)
    c_lo = cluster_lo
    k = np.arange(n_cluster)
    for t in range(leaf_tris):
        sel = (c_lo + t) <= c_hi
        src = sorted_tri[np.minimum(c_lo + t, c_hi)]
        p0 = v0[src]
        e1 = v1[src] - p0
        e2 = v2[src] - p0
        m = sel.astype(np.float32)
        r = 12 * t
        for ax in range(3):
            leaf_rec[k, r + 0 + ax] = p0[:, ax] * m
            leaf_rec[k, r + 3 + ax] = e1[:, ax] * m
            leaf_rec[k, r + 6 + ax] = e2[:, ax] * m
        leaf_rec[k, r + 9] = np.where(sel, src.astype(np.float32), -1.0)
        cluster_tri[:n_cluster, t] = np.where(sel, src, -1).astype(np.int32)

    # refit map: per-slot binary child ids (internal and cluster children
    # both carry a binary node whose refit box is the record value)
    slot_child_bin = np.full((Tn * 128, width), -1, np.int32)
    slot_child_bin[child_parent, slot] = child_bin

    # depth of every wide node below the super-root (0)
    wdepth = np.zeros(n_total, np.int64)
    wpar = np.zeros(n_total, np.int64)
    inner = ~child_is_leaf
    wpar[child_entity[inner]] = child_parent[inner]
    for _ in range(n_total):
        nd = np.where(np.arange(n_total) > 0, wdepth[wpar] + 1, 0)
        if (nd == wdepth).all():
            break
        wdepth = nd

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return WideBVH(nodes_flat=t(node_rec), leaves_flat=t(leaf_rec),
                   meta=t(meta.astype(np.int32)),
                   slot_child_bin=t(slot_child_bin),
                   cluster_tri=t(cluster_tri), num_wide=int(n_total),
                   num_clusters=int(n_cluster), depth=int(wdepth.max()),
                   deep_pushes=torch.zeros(1, dtype=torch.int32,
                                         device=device))


def validate_wide(wide: WideBVH, v0) -> bool:
    """Every triangle appears exactly once across the leaf records."""
    ids = wide.leaves_flat[:, 9::12].reshape(-1).cpu().numpy()
    ids = ids[ids >= 0].astype(np.int64)
    T = v0.shape[0]
    return len(ids) == T and len(np.unique(ids)) == T


def refit_wide(wide: WideBVH, node_min, node_max, v0, v1, v2) -> WideBVH:
    """Frozen-topology record refit: the refit binary boxes
    (ops/bvh.refit_bvh) and the moved triangles → a WideBVH with new
    ``nodes_flat`` / ``leaves_flat``, equal to a fresh ``build_wide``
    over the same binary boxes; torch gathers on the records' device,
    no host work."""
    scb = wide.slot_child_bin.long()
    valid = (scb >= 0).unsqueeze(-1)
    safe = scb.clamp(min=0)
    bmin = torch.where(valid, node_min[safe], 3e38)
    bmax = torch.where(valid, node_max[safe], -3e38)
    # (rows, 8, 6) → (rows, 48): slot c at columns 6c..6c+5
    nodes = torch.cat([bmin, bmax], dim=-1).reshape(scb.shape[0], -1)

    ct = wide.cluster_tri.long()
    rows = ct.shape[0]
    cols = []
    for t in range(ct.shape[1]):
        tid = ct[:, t]
        ok = tid >= 0
        m = ok.float().unsqueeze(-1)
        s = tid.clamp(min=0)
        p0 = v0[s]
        cols += [p0 * m, (v1[s] - p0) * m, (v2[s] - p0) * m,
                 torch.where(ok, tid.float(), -1.0).unsqueeze(-1),
                 torch.zeros((rows, 2), dtype=torch.float32,
                             device=p0.device)]
    leaves = torch.cat(cols, dim=-1)
    return dataclasses.replace(wide, nodes_flat=nodes.contiguous(),
                               leaves_flat=leaves.contiguous())
