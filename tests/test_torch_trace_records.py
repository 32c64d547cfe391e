"""K2 / K2c's records (ops/trace_cuda.pack_bvh ``inner_records`` and
``leaf_rows``), decoded back into the binary tree bit for bit, and the
kernels' traversal over them (csrc/trace.cu: both children in the
parent's record, leaves reached by reference, the near child kept in a
register), replayed here in PyTorch, against the plain version that
walks the per-node records: the same triangle, t, u and v on every ray,
and the same nodes visited. The stress scene's rays are also held
against the reference's traversal (ops/trace.py intersect_bvh)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridrenderer_tpu.ops import bvh as ref_bvh
from hybridrenderer_tpu.ops import trace as ref_trace
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.ops import bvh, trace_cuda
from hybridrenderer_tpu_torch.ops.trace import SceneTracer
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

from .torch_parity import chain_bvh, flatten


def _stress():
    ref_data = ref_scenes.stress_scene(num_objects=12, seed=3).build()
    soup = scene_from_numpy(flatten(ref_data), "cpu").triangles
    v = (soup.v0, soup.v1, soup.v2)
    return bvh.build_sah(*v), v, ref_data


def _case(name):
    """name → (BVH, (v0, v1, v2), its packing through pack_bvh)."""
    if name == "stress12":
        tree, v, _ = _stress()
    elif name == "one_triangle":
        v = tuple(torch.tensor([c], dtype=torch.float32) for c in
                  ([-1.0, 0.0, -1.0], [1.0, 0.0, -1.0], [0.0, 0.0, 1.0]))
        tree = bvh.build_sah(*v)
    elif name == "refit":
        # repacked as SceneTracer.refit does, on the first packing's
        # depth and topology
        tree, v, _ = _stress()
        first = trace_cuda.pack_bvh(tree, *v)
        g = np.random.default_rng(11)
        shift = torch.from_numpy(g.uniform(-0.3, 0.3, (v[0].shape[0], 3))
                                 .astype(np.float32))
        v = tuple(x + shift for x in v)
        tree = bvh.refit_bvh(tree, *v, bvh.refit_levels(tree))
        return tree, v, trace_cuda.pack_bvh(tree, *v, like=first)
    else:
        tree, *v = chain_bvh(trace_cuda.STACK_DEPTH)   # depth 63
        v = tuple(v)
    return tree, v, trace_cuda.pack_bvh(tree, *v)


CASES = ["stress12", "one_triangle", "refit", "chain63"]


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("name", CASES)
def test_records_decode_to_the_tree(name):
    tree, (v0, v1, v2), packed = _case(name)
    n = tree.num_tris - 1
    assert packed.n_internal == n
    rec = packed.inner_records
    rows = packed.leaf_rows
    assert rec.shape == (n, 16) and rows.shape == (n + 1, 12)
    assert rec.dtype == rows.dtype == torch.float32
    if name == "one_triangle":
        assert n == 0 and packed.depth == 0
    if name == "chain63":
        assert packed.depth == trace_cuda.STACK_DEPTH - 1
    for side, child in ((0, tree.left[:n].long()), (8, tree.right[:n].long())):
        ref = _bits(rec[:, side + 3]).long()
        # a reference names an internal node, or leaf ~ref = node n + ~ref
        node = torch.where(ref >= 0, ref, n + (-1 - ref))
        assert torch.equal(node, child)
        assert torch.equal(ref >= 0, child < n)
        assert torch.equal(_bits(rec[:, side:side + 3]),
                           _bits(tree.node_min[child]))
        assert torch.equal(_bits(rec[:, side + 4:side + 7]),
                           _bits(tree.node_max[child]))
        assert (_bits(rec[:, side + 7]) == 0).all()
    tri = tree.tri[n:].long()
    assert (tri >= 0).all()
    assert torch.equal(_bits(rows[:, 3]).long(), tri)
    assert torch.equal(_bits(rows[:, 0:3]), _bits(v0[tri]))
    assert torch.equal(_bits(rows[:, 4:7]), _bits(v1[tri] - v0[tri]))
    assert torch.equal(_bits(rows[:, 8:11]), _bits(v2[tri] - v0[tri]))
    assert (_bits(rows[:, 7]) == 0).all() and (_bits(rows[:, 11]) == 0).all()


def replay_kernel(packed, o, d, tmin, tmax, active, any_hit):
    """csrc/trace.cu's traversal over ``inner_records`` / ``leaf_rows``,
    all rays one step at a time: an internal step tests both boxes of its
    record, pushes the far child when both are hit and goes on with the
    near one (or the one hit); a leaf step tests its row; a miss or a
    leaf pops. The stack holds ``depth`` entries (at least 1) and a push
    beyond them fails the replay. → (best t, tri, u, v, visits, the
    deepest stack)."""
    R = o.shape[0]
    n = packed.n_internal
    cap = max(packed.depth, 1)
    rec = packed.inner_records.view(-1, 4, 4)
    rows = packed.leaf_rows.view(-1, 3, 4)
    tiny = torch.where(d < 0, -1e-12, 1e-12)
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-12, tiny, d)
    idx = torch.arange(R)
    ref = torch.full((R,), 0 if n > 0 else -1, dtype=torch.long)
    live = active.clone()
    stack = torch.zeros((R, cap), dtype=torch.long)
    sp = torch.zeros((R,), dtype=torch.long)
    best = tmax.clone()
    out = torch.full((R,), -1, dtype=torch.int32)
    bu = torch.zeros((R,), dtype=torch.float32)
    bv = torch.zeros((R,), dtype=torch.float32)
    visits = {"internal": 0, "leaf": 0}
    deepest = 0
    while bool(live.any()):
        inner = live & (ref >= 0)
        leaf = live & (ref < 0)
        visits["internal"] += int(inner.sum())
        visits["leaf"] += int(leaf.sum())
        pop = leaf.clone()
        if n > 0:
            r = rec[torch.clamp(ref, 0, n - 1)]
            lref = _bits(r[:, 0, 3]).long()
            rref = _bits(r[:, 2, 3]).long()
            lhit, lt = trace_cuda.ray_aabb(o, inv_d, r[:, 0, :3], r[:, 1, :3],
                                           tmin, best)
            rhit, rt = trace_cuda.ray_aabb(o, inv_d, r[:, 2, :3], r[:, 3, :3],
                                           tmin, best)
            lhit, rhit = lhit & inner, rhit & inner
            both = lhit & rhit
            l_nearer = lt <= rt
            assert not bool((both & (sp >= cap)).any()), "stack overflow"
            slot = torch.clamp(sp, max=cap - 1)
            stack[idx, slot] = torch.where(
                both, torch.where(l_nearer, rref, lref), stack[idx, slot])
            sp = sp + both.long()
            deepest = max(deepest, int(sp.max()))
            nxt = torch.where(both, torch.where(l_nearer, lref, rref),
                              torch.where(lhit, lref, rref))
            ref = torch.where(lhit | rhit, nxt, ref)
            pop = pop | (inner & ~(lhit | rhit))
        row = rows[torch.clamp(-1 - ref, min=0)]
        tri = _bits(row[:, 0, 3])
        hit, t, u, v = trace_cuda.ray_triangle_edges(
            o, d, row[:, 0, :3], row[:, 1, :3], row[:, 2, :3], tmin, best)
        take = leaf & (tri >= 0) & hit
        out = torch.where(take, tri, out)
        best = torch.where(take, t, best)
        bu = torch.where(take, u, bu)
        bv = torch.where(take, v, bv)
        if any_hit:
            live = live & ~take
            pop = pop & live
        live = live & ~(pop & (sp == 0))
        pop = pop & live
        sp = torch.where(pop, sp - 1, sp)
        ref = torch.where(pop, stack[idx, torch.clamp(sp, 0, cap - 1)], ref)
    return best, out, bu, bv, visits, deepest


def _rays(name, n):
    g = np.random.default_rng(4)
    if name == "chain63":
        # along -x from beyond the last triangle: every chain node's box
        # is nearer than its leaf, so each leaf waits on the stack; and
        # along +x, where each leaf is nearer
        o = np.stack([np.where(np.arange(n) % 2 == 0, 80.0, -20.0),
                      g.uniform(-0.4, 0.4, n), g.uniform(-0.4, 0.4, n)], 1)
        d = np.stack([np.where(np.arange(n) % 2 == 0, -1.0, 1.0),
                      g.uniform(-0.01, 0.01, n), g.uniform(-0.01, 0.01, n)],
                     1)
        tmax = np.full(n, 1e6)
    else:
        lo, hi = ([-20, 0.05, -10], [20, 6, 10]) if name != "one_triangle" \
            else ([-2, -2, -2], [2, 2, 2])
        o = g.uniform(lo, hi, (n, 3))
        d = g.standard_normal((n, 3))
        if name == "one_triangle":
            d = -o + g.uniform(-1.5, 1.5, (n, 3))
        tmax = g.choice([10.0, 1e6], n)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    active = g.random(n) < 0.9
    return tuple(torch.from_numpy(np.ascontiguousarray(x, dtype=dt))
                 for x, dt in ((o, np.float32), (d, np.float32),
                               (tmax, np.float32), (active, bool)))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_kernel_order_equals_plain(name, any_hit):
    """The replayed kernel and the plain version agree bit for bit on
    every ray (the any-hit triangle and equal-t choices included) and
    visit the same number of internal and leaf nodes; on the chain, the
    stack fills to the tree's depth and no further."""
    _, _, packed = _case(name)
    o, d, tmax, active = _rays(name, 1024)
    plain_visits = {}
    t, tri, u, vv = trace_cuda._traverse_plain(packed, o, d, 0.01, tmax,
                                                active, any_hit, plain_visits)
    kt, ktri, ku, kv, visits, deepest = replay_kernel(packed, o, d, 0.01,
                                                      tmax, active, any_hit)
    assert torch.equal(ktri, tri)
    for a, b in ((kt, t), (ku, u), (kv, vv)):
        assert torch.equal(_bits(a), _bits(b))
    assert visits == plain_visits
    hit = (tri >= 0)[active].float().mean().item()
    assert 0.05 < hit
    assert (ktri[~active] == -1).all()
    if name == "chain63":
        assert deepest == packed.depth == trace_cuda.STACK_DEPTH - 1


def test_kernel_order_matches_reference():
    """The replayed kernel's any-hit visibility against the reference's
    traversal on the same SAH tree, inactive rays as tmax 0 there."""
    tree, v, ref_data = _stress()
    soup = ref_data.triangles
    ref_tree = ref_bvh.build_bvh_host(soup.v0, soup.v1, soup.v2, "sah")
    packed = trace_cuda.pack_bvh(tree, *v)
    o, d, tmax, active = _rays("stress12", 2048)
    _, ref_tri, _, _ = ref_trace.intersect_bvh(
        ref_tree, soup.v0, soup.v1, soup.v2, jnp.asarray(o.numpy()),
        jnp.asarray(d.numpy()), 0.01,
        jnp.asarray(np.where(active.numpy(), tmax.numpy(), 0.0)),
        any_hit=True)
    tri = replay_kernel(packed, o, d, 0.01, tmax, active, True)[1].numpy()
    ref_vis = np.asarray(ref_tri) >= 0
    assert 0.1 < ref_vis.mean() < 0.9
    # at most 0.1% of rays may flip, for grazing hits
    assert ((tri >= 0) != ref_vis).mean() <= 1e-3


@pytest.mark.parametrize("backend", ["pallas", "auto"])
def test_records_only_where_k2_traces(backend):
    """SceneTracer packs the kernels' records for the per-ray kernels and
    for the packet kernel K2b alike: pack_bvh's per-node layout and
    records, before and after a refit, with the depth of the stack the
    traversal has."""
    ref_data = ref_scenes.stress_scene(num_objects=12, seed=3).build()
    data = scene_from_numpy(flatten(ref_data), "cpu")
    tracer = SceneTracer.build(data, RenderSettings(trace_backend=backend))
    soup = data.triangles
    full = trace_cuda.pack_bvh(tracer.bvh, soup.v0, soup.v1, soup.v2,
                               trace_cuda.PACKET_STACK_DEPTH)
    for packed in (tracer.packed, tracer.refit(data).packed):
        names = ["nodes", "node_tri", "tri_verts", "inner_records",
                 "leaf_rows"]
        for name in names:   # the child-id bits are NaNs as floats
            assert torch.equal(_bits(getattr(packed, name)),
                               _bits(getattr(full, name))), name
        assert packed.depth == full.depth
