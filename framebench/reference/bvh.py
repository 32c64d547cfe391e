"""The reference's own ray queries: a complete binary tree over the
triangles in Morton order, traversed without a stack.

The triangles are sorted by the Morton code of their centroids and cut
into leaves of LEAF triangles; the tree over the leaves is complete and
implicit (heap order: node n's children are 2n and 2n + 1, the root is
1), padded with empty leaves, each node's box the union of its
children's, widened a little so that rounding in the box test never
loses a hit. A ray walks the tree in pre-order: into the first child
where it meets a node's box, else on to the next node past its subtree,
(n + 1) / lowbit(n + 1); it is done when that is the root. All rays
step together, the finished dropped after each step.

The hit test is Möller-Trumbore, both faces, inclusive of the edges and
of both ends of [tmin, tmax]."""
from __future__ import annotations

import torch

LEAF = 4
DET_EPS = 1e-9


def _spread(x):
    """10-bit integers → their bits three apart."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


class Tree:
    def __init__(self, v0, v1, v2):
        dev = v0.device
        T = v0.shape[0]
        c = (v0 + v1 + v2) / 3.0
        lo, hi = c.amin(0), c.amax(0)
        q = ((c - lo) / torch.clamp(hi - lo, min=1e-20) * 1023.0)
        q = torch.clamp(q, 0, 1023).long()
        code = (_spread(q[:, 0]) << 2) | (_spread(q[:, 1]) << 1) \
            | _spread(q[:, 2])
        order = torch.sort(code, stable=True).indices
        leaves = max(1, -(-T // LEAF))
        self.depth = (leaves - 1).bit_length()
        self.first_leaf = 1 << self.depth
        slots = self.first_leaf * LEAF
        self.tri = torch.full((slots,), -1, dtype=torch.int64, device=dev)
        self.tri[:T] = order
        p0 = torch.zeros((slots, 3), device=dev)
        e1, e2 = torch.zeros_like(p0), torch.zeros_like(p0)
        p0[:T], e1[:T], e2[:T] = v0[order], v1[order] - v0[order], \
            v2[order] - v0[order]
        self.p0, self.e1, self.e2 = p0, e1, e2

        inf = float("inf")
        tri_lo = torch.full((slots, 3), inf, device=dev)
        tri_hi = torch.full((slots, 3), -inf, device=dev)
        corners = torch.stack([v0[order], v1[order], v2[order]], 1)
        tri_lo[:T], tri_hi[:T] = corners.amin(1), corners.amax(1)
        n_nodes = 2 * self.first_leaf
        self.lo = torch.full((n_nodes, 3), inf, device=dev)
        self.hi = torch.full((n_nodes, 3), -inf, device=dev)
        self.lo[self.first_leaf:] = tri_lo.view(-1, LEAF, 3).amin(1)
        self.hi[self.first_leaf:] = tri_hi.view(-1, LEAF, 3).amax(1)
        level = self.first_leaf
        while level > 1:
            half = level // 2
            kids_lo = self.lo[level:2 * level].view(half, 2, 3)
            kids_hi = self.hi[level:2 * level].view(half, 2, 3)
            self.lo[half:level] = kids_lo.amin(1)
            self.hi[half:level] = kids_hi.amax(1)
            level = half
        self.filled = (self.lo <= self.hi).all(-1)
        pad = 1e-5 * (self.lo.abs() + self.hi.abs()) + 1e-6
        self.lo = torch.where(self.filled[:, None], self.lo - pad,
                              torch.zeros_like(self.lo))
        self.hi = torch.where(self.filled[:, None], self.hi + pad,
                              torch.zeros_like(self.hi))

    def query(self, o, d, tmin: float, tmax, active, any_hit: bool):
        """Rays o, d (R, 3), tmax (R,), active (R,) → (t, triangle, u,
        v) of the nearest hit in [tmin, tmax] (any-hit: of some hit),
        triangle -1 where none; u, v weigh the triangle's second and
        third corners."""
        dev = o.device
        R = o.shape[0]
        tiny = torch.where(d < 0, -1e-12, 1e-12)
        inv_d = 1.0 / torch.where(d.abs() < 1e-12, tiny, d)
        best = tmax.clone()
        tri = torch.full((R,), -1, dtype=torch.int64, device=dev)
        bu = torch.zeros((R,), device=dev)
        bv = torch.zeros((R,), device=dev)
        live = torch.nonzero(active).squeeze(1)
        node = torch.ones_like(live)
        while live.numel():
            lo, hi = self.lo[node], self.hi[node]
            oo, ii = o[live], inv_d[live]
            t0, t1 = (lo - oo) * ii, (hi - oo) * ii
            near = torch.minimum(t0, t1).amax(-1)
            far = torch.maximum(t0, t1).amin(-1)
            enter = self.filled[node] & (near <= far) & (far >= tmin) \
                & (near <= best[live])
            leaf = node >= self.first_leaf
            done = torch.zeros_like(enter)
            at = torch.nonzero(enter & leaf).squeeze(1)
            if at.numel():
                rays = live[at]
                slots = (node[at] - self.first_leaf)[:, None] * LEAF \
                    + torch.arange(LEAF, device=dev)
                t, u, v, ok = _hits(o[rays][:, None], d[rays][:, None],
                                    self.p0[slots], self.e1[slots],
                                    self.e2[slots], tmin,
                                    best[rays][:, None])
                t = torch.where(ok, t, torch.full_like(t, float("inf")))
                t_best, k = t.min(1)
                got = ok.any(1)
                pick = torch.arange(at.numel(), device=dev)
                rays_g = rays[got]
                best[rays_g] = t_best[got]
                tri[rays_g] = self.tri[slots[pick, k]][got]
                bu[rays_g] = u[pick, k][got]
                bv[rays_g] = v[pick, k][got]
                if any_hit:
                    done[at[got]] = True
            down = enter & ~leaf
            nxt = torch.where(down, 2 * node, node + 1)
            up = ~down
            nxt = torch.where(up, nxt // (nxt & -nxt), nxt)
            keep = ~done & (nxt != 1)
            live, node = live[keep], nxt[keep]
        return best, tri, bu, bv


def _hits(o, d, p0, e1, e2, tmin, tmax):
    """Möller-Trumbore over broadcast rays and triangles → (t, u, v,
    hit)."""
    def cross(a, b):
        return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                           -1)

    def dot(a, b):
        return (a * b).sum(-1)

    p = cross(d, e2)
    det = dot(e1, p)
    ok = det.abs() >= DET_EPS
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    s = o - p0
    u = dot(s, p) * inv
    q = cross(s, e1)
    v = dot(d, q) * inv
    t = dot(e2, q) * inv
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= tmin) & (t <= tmax)
    return t, u, v, hit
