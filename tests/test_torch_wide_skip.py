"""The facts K2w and K2m rely on to skip tests that cannot change a result
(csrc/trace.cu), checked on the 8-wide trees of the cube, cornell and
stress (25 objects) scenes, as built and after a refit, and the plain
versions' step counters (ops/trace_cuda.py):

* the last leaf row, the dummy leaf an idle pop would test, holds no
  triangle (ids -1);
* every real child slot (in a node's imask | lmask) has a finite box;
* so an any-hit ray that has a hit, which slab-tests against -inf,
  votes for no real slot, whatever its origin and direction;
* a ray with t < tmin (an inactive ray, t = -1) gains no hit from any
  leaf;
* a program runs a multiple of 16 steps, at least as many as any of its
  packets (rows) pops of each kind, and the idle counters are its
  packet (row) steps less the pops."""
import functools

import numpy as np
import pytest
import torch

from hybridrenderer_tpu_torch.ops import bvh, bvh_wide, trace_cuda
from hybridrenderer_tpu_torch.scene import scene as scenes

SCENES = {"cube": scenes.cube_scene, "cornell": scenes.cornell_scene,
          "stress25": lambda: scenes.stress_scene(num_objects=25)}
TMIN = 0.01


@functools.cache
def _tree(name, refit):
    s = SCENES[name]().build("cpu").triangles
    v = [s.v0, s.v1, s.v2]
    tree = bvh.build_sah(*v)
    wide = bvh_wide.build_wide(tree, *v)
    if refit:
        # every third triangle shifted, every fifth scaled about the origin
        k = torch.arange(v[0].shape[0])
        shift = torch.tensor([0.3, -0.2, 0.45]) * (k % 3 == 0).float()[:, None]
        grow = torch.where(k % 5 == 0, 1.5, 1.0)[:, None]
        v = [(x + shift) * grow for x in v]
        moved = bvh.refit_bvh(tree, *v, bvh.refit_levels(tree))
        wide = bvh_wide.refit_wide(wide, moved.node_min, moved.node_max, *v)
    return wide, v


def _real_slots(wide):
    """(Nw, 8) bool: the slots in each node's imask | lmask."""
    meta = wide.meta.long()
    mask = (meta[:, 0] | meta[:, 1]) & 255
    return (mask[:, None] >> torch.arange(8)) & 1 == 1


def _rays(v, R, seed):
    """Origins around and inside the scene's boxes, directions with some
    components exactly 0 (the slab test's 1e12 reciprocal cap)."""
    g = np.random.default_rng(seed)
    pts = v[0].numpy()
    lo, hi = pts.min(0), pts.max(0)
    o = g.uniform(lo - 0.5 * (hi - lo), hi + 0.5 * (hi - lo), (R, 3))
    o[: R // 8] = pts[g.integers(0, len(pts), R // 8)]   # on triangles
    d = g.standard_normal((R, 3))
    d[R // 4: R // 2, g.integers(0, 3)] = 0.0
    d[R // 2: R // 2 + R // 8, :2] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.from_numpy(x.astype(np.float32)) for x in (o, d))


def _bundle(v, R, seed):
    """R rays from one eye towards points scattered around the scene's
    centre, as a camera's tile would cast them."""
    g = np.random.default_rng(seed)
    pts = v[0].numpy()
    lo, hi = pts.min(0), pts.max(0)
    c = (lo + hi) / 2
    eye = c + np.array([0.0, 0.3, 1.2]) * (hi - lo).max()
    d = c + g.normal(0, 0.03, (R, 3)) * (hi - lo) - eye
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.from_numpy(x.astype(np.float32))
            for x in (np.repeat(eye[None], R, 0), d))


CASES = [(n, r) for n in SCENES for r in (False, True)]


@pytest.mark.parametrize("name,refit", CASES)
def test_dummy_leaf_row_holds_no_triangle(name, refit):
    wide, _ = _tree(name, refit)
    assert wide.leaves_flat.shape[0] > wide.num_clusters
    last = wide.leaves_flat[-1]
    assert (last[9::12] == -1.0).all()
    assert (wide.cluster_tri[-1] == -1).all()


@pytest.mark.parametrize("name,refit", CASES)
def test_real_slot_boxes_are_finite(name, refit):
    wide, _ = _tree(name, refit)
    real = _real_slots(wide)
    boxes = wide.nodes_flat[:wide.num_wide].view(-1, 8, 6)
    assert real.any()
    assert torch.isfinite(boxes[real]).all()
    # the slots outside the masks keep the inverted empty box
    empty = ~real
    assert (boxes[empty][:, :3] == 3e38).all()
    assert (boxes[empty][:, 3:] == -3e38).all()


@pytest.mark.parametrize("name,refit", CASES)
def test_any_hit_rays_with_a_hit_vote_for_no_real_slot(name, refit):
    """The plain version's slab tests of every wide node against rays
    that all have a hit (tb = -inf): no bit inside imask | lmask, though
    the same rays without a hit do vote."""
    wide, v = _tree(name, refit)
    o, d = _rays(v, 512, 3)
    ray = [x.unsqueeze(0) for x in trace_cuda._ray_planes(o, d)]
    rec = wide.nodes_flat[:wide.num_wide]
    meta = wide.meta.long()
    mask = (meta[:, 0] | meta[:, 1]) & 255
    t = torch.full((1, o.shape[0]), 1e6)
    for tri in (0, trace_cuda.INACTIVE_TRI):
        st = dict(t=t, tri=torch.full(t.shape, tri, dtype=torch.int32))
        hm = trace_cuda._node_votes(rec, ray, TMIN, st, True)
        assert (hm & mask == 0).all()
    st = dict(t=t, tri=torch.full(t.shape, -1, dtype=torch.int32))
    assert (trace_cuda._node_votes(rec, ray, TMIN, st, True) & mask).any()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_rays_below_tmin_gain_no_hit(name):
    """Every leaf cluster's triangles against rays with t = -1 (inactive)
    and t just below tmin: nothing changes; with t = 1e6 some hit."""
    wide, v = _tree(name, False)
    o, d = _rays(v, 64, 5)
    ray = [x.unsqueeze(0) for x in trace_cuda._ray_planes(o, d)]
    rec = wide.leaves_flat[:wide.num_clusters]
    shape = (rec.shape[0], o.shape[0])
    for t0 in (-1.0, np.nextafter(np.float32(TMIN), np.float32(0)), 1e6):
        st = dict(t=torch.full(shape, float(t0)),
                  tri=torch.full(shape, -1, dtype=torch.int32),
                  u=torch.zeros(shape), v=torch.zeros(shape))
        trace_cuda._leaf_visit(rec, ray, TMIN, st)
        hit = st["tri"] >= 0
        if t0 < TMIN:
            assert not hit.any() and (st["t"] == float(t0)).all()
        else:
            assert hit.any()


@pytest.mark.parametrize("mimt", [False, True])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_program_steps_cover_every_pop(monkeypatch, name, mimt):
    """One program (2,048 rays from one eye, 10% inactive) over the refit
    tree, closest-hit then any-hit: steps a multiple of 16 and at least every
    packet's (row's) pops of each kind, counted here from the stacks the
    step functions see; the idle counters are the packet (row) steps
    less the pops."""
    wide, v = _tree(name, True)
    o, d = _bundle(v, 2048, 7)
    g = np.random.default_rng(7)
    tmax = torch.from_numpy(g.choice([3.0, 1e6], 2048).astype(np.float32))
    active = torch.from_numpy(g.random(2048) < 0.9)
    step_name = "_mimt_step" if mimt else "_wide_step"
    real = getattr(trace_cuda, step_name)
    pops = {}

    def counting(wide_, meta, st, ray, tmin, any_hit, count):
        # the pop rules of the kernels (csrc/trace.cu): a packet (row)
        # pops a leaf if it has one, a node if it has one and its leaf
        # stack cannot overflow this step
        room = trace_cuda.WIDE_LEAF_STACK - (8 if mimt else 1)
        ivalid = (st["isp"] > 0) & (st["lsp"] <= room)
        lvalid = st["lsp"] > 0
        pops["i"] = pops.get("i", 0) + ivalid.long()
        pops["l"] = pops.get("l", 0) + lvalid.long()
        pops["any"] = pops.get("any", 0) + (ivalid | lvalid).long()
        real(wide_, meta, st, ray, tmin, any_hit, count)

    monkeypatch.setattr(trace_cuda, step_name, counting)
    plain = trace_cuda.intersect_mimt_plain if mimt \
        else trace_cuda.intersect_wide_plain
    units = 2 * (trace_cuda.WIDE_ROWS if mimt else 1)
    for any_hit in (False, True):
        pops.clear()
        visits = {}
        plain(wide, o, d, TMIN, tmax, active, any_hit, visits=visits)
        steps = visits["steps"]
        assert steps > 0 and steps % trace_cuda.WIDE_CHUNK == 0
        assert pops["i"].numel() == units
        assert int(pops["i"].max()) <= steps
        assert int(pops["l"].max()) <= steps
        assert int(pops["i"].sum()) == visits["internal"]
        assert int(pops["l"].sum()) == visits["leaf"]
        assert visits["idle_internal"] == units * steps - visits["internal"]
        assert visits["idle_leaf"] == units * steps - visits["leaf"]
        # a packet (row) pops something every step until both its stacks
        # are empty; closest-hit, the longest one sets the program's
        # length, rounded up to 16
        longest = int(pops["any"].max())
        assert longest <= steps
        if not any_hit:
            assert steps - trace_cuda.WIDE_CHUNK < longest
