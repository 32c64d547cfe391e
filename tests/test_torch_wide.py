"""Port vs reference: the 8-wide BVH (ops/bvh_wide.py), its refit and the
binary refit (ops/bvh.py), and the plain versions of the wide traversals
K2w and K2m (ops/trace_cuda.py intersect_wide_plain / intersect_mimt_plain)
against the reference's Pallas kernels in interpret mode, all on the same
native SAH tree; plus the wide settings and SceneTracer's handling of the
kernels' conventions."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridrenderer_tpu.ops import bvh as ref_bvh
from hybridrenderer_tpu.ops import bvh_wide as ref_wide
from hybridrenderer_tpu.ops import image as ref_image
from hybridrenderer_tpu.ops import trace_pallas
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.ops import bvh, bvh_wide, trace, trace_cuda
from hybridrenderer_tpu_torch.ops.trace import SceneTracer
from hybridrenderer_tpu_torch.scene import scene as port_scenes

from .torch_parity import one_torch_thread

RECORDS = ("nodes_flat", "leaves_flat", "meta", "slot_child_bin",
           "cluster_tri")
SCENES = {"cube": ref_scenes.cube_scene, "cornell": ref_scenes.cornell_scene,
          "stress25": lambda: ref_scenes.stress_scene(num_objects=25)}


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _soup(name):
    s = SCENES[name]().build().triangles
    return [torch.from_numpy(np.array(x)) for x in (s.v0, s.v1, s.v2)]


def _jnp_bvh(b):
    return ref_bvh.BVH(*(jnp.asarray(getattr(b, f).numpy()) for f in (
        "node_min", "node_max", "left", "right", "tri")),
        num_tris=b.num_tris)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_wide_equals_reference(name):
    """The port's records equal the reference build_wide's flat records
    exactly, over the port's native SAH tree; every triangle sits in
    exactly one cluster."""
    v = _soup(name)
    tree = bvh.build_sah(*v)
    wide = bvh_wide.build_wide(tree, *v)
    ref = ref_wide.build_wide(tree, *(x.numpy() for x in v))
    for f in RECORDS:
        np.testing.assert_array_equal(getattr(wide, f).numpy(),
                                      getattr(ref, f), err_msg=f)
    assert (wide.num_wide, wide.num_clusters) == (ref.num_wide,
                                                   ref.num_clusters)
    assert wide.vmem_bytes == ref.vmem_bytes
    assert bvh_wide.validate_wide(wide, v[0])
    # the super-root's single internal child is the root, in slot 0
    assert wide.meta[0, 0] == (1 << 8) | 1 and wide.meta[0, 1] == 0
    assert 2 <= wide.depth <= 6


def _moved(v, scale):
    """Every third triangle shifted and a fifth scaled about the origin."""
    k = torch.arange(v[0].shape[0])
    shift = torch.tensor([0.3, -0.2, 0.45]) * (k % 3 == 0).float()[:, None]
    grow = torch.where(k % 5 == 0, scale, 1.0)[:, None]
    return [(x + shift) * grow for x in v]


@pytest.mark.parametrize("name", ["cornell", "stress25"])
def test_refits_equal_reference(name):
    """After the triangles move, the binary refit equals the reference's
    refit_bvh (scan over tree_height sweeps) and refit_bvh_rmq exactly,
    and refit_wide equals the reference's refit_wide and a fresh
    build_wide over the refit tree; refitting the unmoved triangles
    gives the build's boxes back."""
    v = _soup(name)
    tree = bvh.build_sah(*v)
    levels = bvh.refit_levels(tree)
    height = len(levels)
    assert height == ref_bvh.tree_height(
        tree.left.numpy(), tree.right.numpy(), tree.num_tris)
    same = bvh.refit_bvh(tree, *v, levels)
    np.testing.assert_array_equal(same.node_min, tree.node_min)
    np.testing.assert_array_equal(same.node_max, tree.node_max)

    mv = _moved(v, 1.5)
    port = bvh.refit_bvh(tree, *mv, levels)
    jv = [jnp.asarray(x.numpy()) for x in mv]
    ref = ref_bvh.refit_bvh(_jnp_bvh(tree), *jv, max_depth_iters=height)
    rows, K = ref_bvh.refit_plan(tree.left.numpy(), tree.right.numpy(),
                                 tree.num_tris)
    rmq = ref_bvh.refit_bvh_rmq(_jnp_bvh(tree), *jv, jnp.asarray(rows), K)
    for r in (ref, rmq):
        np.testing.assert_array_equal(port.node_min.numpy(),
                                      np.asarray(r.node_min))
        np.testing.assert_array_equal(port.node_max.numpy(),
                                      np.asarray(r.node_max))

    wide = bvh_wide.build_wide(tree, *v)
    refit = bvh_wide.refit_wide(wide, port.node_min, port.node_max, *mv)
    scb, ct = (jnp.asarray(getattr(wide, f).numpy())
               for f in ("slot_child_bin", "cluster_tri"))
    _, _, rnodes, rleaves = ref_wide.refit_wide(
        scb, ct, jnp.asarray(port.node_min.numpy()),
        jnp.asarray(port.node_max.numpy()), *jv)
    np.testing.assert_array_equal(refit.nodes_flat.numpy(),
                                  np.asarray(rnodes))
    np.testing.assert_array_equal(refit.leaves_flat.numpy(),
                                  np.asarray(rleaves))
    fresh = bvh_wide.build_wide(port, *mv)
    np.testing.assert_array_equal(refit.nodes_flat, fresh.nodes_flat)
    np.testing.assert_array_equal(refit.leaves_flat, fresh.leaves_flat)


def _rays(v0, R, seed):
    g = np.random.default_rng(seed)
    v0 = v0.numpy()
    c, ext = v0.mean(0), v0.max(0) - v0.min(0)
    o = (c + g.normal(0, 0.3, (R, 3)) * ext).astype(np.float32)
    d = g.normal(0, 1, (R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = g.choice([3.0, 1e6], R).astype(np.float32)
    return o, d, tmax, g.random(R) < 0.9


@pytest.fixture(scope="module")
def cornell_wide():
    v = _soup("cornell")
    tree = bvh.build_sah(*v)
    return v, bvh_wide.build_wide(tree, *v), ref_wide.build_wide(
        tree, *(x.numpy() for x in v))


@pytest.mark.parametrize("kernel", ["compressed", "mimt"])
@pytest.mark.parametrize("any_hit", [True, False])
def test_wide_plain_matches_pallas_kernel(cornell_wide, kernel, any_hit):
    """2,048 rays (one program of two packets) on cornell, with an active
    mask and a per-ray tmax, against intersect_wide / intersect_mimt in
    interpret mode (chunk_unroll 1): hit / miss and the reported
    triangle equal, any-hit's included (the port keeps the reference's
    visiting order and termination rule; these rays have no equal-t
    tie), closest t to 1e-4 (test_trace_wide.py's gate; reading 1.2e-7)
    and u, v to 1e-5 (reading 9.5e-7) where they hit: XLA rounds the
    Moller-Trumbore terms apart from PyTorch. Inactive rays report the
    sentinel id with t = -1."""
    v, wide, ref = cornell_wide
    o, d, tmax, act = _rays(v[0], 2048, 7)
    tmin = 1e-3
    j = dict(any_hit=any_hit, interpret=True, active=jnp.asarray(act),
             chunk_unroll=1)
    if kernel == "mimt":
        rt = trace_pallas.intersect_mimt(
            trace_pallas.pack_p8(jnp.asarray(ref.nodes_flat)),
            trace_pallas.pack_p8(jnp.asarray(ref.leaves_flat)),
            jnp.asarray(ref.meta), jnp.asarray(o), jnp.asarray(d), tmin,
            jnp.asarray(tmax), **j)
        plain = trace_cuda.intersect_mimt
    else:
        rt = trace_pallas.intersect_wide(
            jnp.asarray(ref.nodes), jnp.asarray(ref.leaves),
            jnp.asarray(ref.meta), jnp.asarray(o), jnp.asarray(d), tmin,
            jnp.asarray(tmax), **j)
        plain = trace_cuda.intersect_wide
    rt, rtri, ru, rv = (np.asarray(x) for x in rt)
    t, tri, u, v_ = (x.numpy() for x in plain(
        wide, *(torch.from_numpy(x) for x in (o, d)), tmin,
        torch.from_numpy(tmax), torch.from_numpy(act), any_hit))
    np.testing.assert_array_equal(tri, rtri)
    assert (tri[~act] == trace_cuda.INACTIVE_TRI).all()
    assert (t[~act] == -1.0).all()
    hit = (rtri >= 0) & act
    assert 0.2 < hit.mean() < 0.9
    if not any_hit:
        np.testing.assert_allclose(t[hit], rt[hit], rtol=0, atol=1e-4)
    np.testing.assert_allclose(u[hit], ru[hit], rtol=0, atol=1e-5)
    np.testing.assert_allclose(v_[hit], rv[hit], rtol=0, atol=1e-5)
    assert np.isinf(t[act & (tri < 0)]).all()
    assert int(wide.deep_pushes) == 0


@pytest.mark.parametrize("kernel", ["compressed", "mimt"])
def test_leaf_stack_stall_keeps_every_hit(monkeypatch, kernel):
    """With leaf stacks shrunk to 12 entries, the packets stall their
    internal pops on most steps, and still every query agrees with the
    per-ray K2 / K2c over the binary tree: visibility exactly, closest t
    exactly (the same triangle tests in the same arithmetic)."""
    v = _soup("stress25")
    tree = bvh.build_sah(*v)
    wide = bvh_wide.build_wide(tree, *v)
    packed = trace_cuda.pack_bvh(tree, *v)
    o, d, tmax, act = (torch.from_numpy(x) for x in _rays(v[0], 2048, 3))
    f = trace_cuda.intersect_mimt if kernel == "mimt" \
        else trace_cuda.intersect_wide
    monkeypatch.setattr(trace_cuda, "WIDE_LEAF_STACK", 12)
    vis = f(wide, o, d, 0.01, tmax, act, True)[1]
    t, tri, _, _ = f(wide, o, d, 0.01, tmax, act, False)
    ref_vis = trace_cuda.intersect_any(packed, o, d, 0.01, tmax, act)
    ref_t = trace_cuda.intersect_closest(packed, o, d, 0.01, tmax, act)[0]
    assert torch.equal((vis >= 0) & (vis != trace_cuda.INACTIVE_TRI),
                       ref_vis >= 0)
    assert torch.equal(t[act], ref_t[act])
    assert 0.1 < (ref_vis >= 0).float().mean() < 0.9


def test_wide_settings_validation():
    """wide_kernel takes None, "direct", "compressed" or "mimt", and only
    with trace_backend "pallas-wide"; the wide tree's shape fields take
    the reference's values (bvh_width 8 or 16, bvh_leaf_tris 4, 8 or 16,
    None for the defaults) and refuse others, naming them."""
    RenderSettings(trace_backend="pallas-wide", wide_kernel="mimt")
    for kw in (dict(wide_kernel="compressed"),
               dict(trace_backend="pallas", wide_kernel="mimt"),
               dict(trace_backend="pallas-wide", wide_kernel="packet")):
        with pytest.raises(ValueError):
            RenderSettings(**kw)
    for kw in (dict(bvh_leaf_tris=8), dict(bvh_width=16),
               dict(bvh_width=8, bvh_leaf_tris=16), dict(bvh_width=None)):
        RenderSettings(trace_backend="pallas-wide", **kw)
    for kw, names in ((dict(bvh_leaf_tris=6), "4, 8, 16"),
                      (dict(bvh_width=4), "8, 16")):
        with pytest.raises(ValueError, match=names):
            RenderSettings(trace_backend="pallas-wide", **kw)
    data = port_scenes.cube_scene().build("cpu")
    for k in (None, "direct"):
        t = SceneTracer.build(data, RenderSettings(
            trace_backend="pallas-wide", wide_kernel=k))
        assert t.wide is None and t.packed is not None


def test_wide_tracer_limits(monkeypatch):
    """Above the reference's record budget the wide kernels give way as
    the reference's do (there, beyond even its bf16 node records, to the
    exact traversal: K2 / K2c over the f32 tree;
    tests/test_torch_bf16_records.py holds every branch), and the wide
    kernels raise on a tree too deep for the internal-node stacks: K2w
    needs depth + 1 entries, K2m 7 depth + 1, of 128."""
    data = port_scenes.cube_scene().build("cpu")
    s = RenderSettings(trace_backend="pallas-wide", wide_kernel="mimt")
    monkeypatch.setattr(trace, "VMEM_SCENE_BUDGET", 1024)
    t = SceneTracer.build(data, s)
    assert (t.wide, t.wide_kernel, t.quantized, t.backend) == \
        (None, None, False, "jnp") and t.packed is not None
    assert t.demotion.startswith("exact")
    monkeypatch.undo()
    wide = SceneTracer.build(data, s).wide
    trace_cuda.check_wide_stacks(dataclasses.replace(wide, depth=18), True)
    trace_cuda.check_wide_stacks(dataclasses.replace(wide, depth=127), False)
    with pytest.raises(ValueError, match="stack"):
        trace_cuda.check_wide_stacks(dataclasses.replace(wide, depth=19),
                                     True)
    with pytest.raises(ValueError, match="stack"):
        trace_cuda.check_wide_stacks(dataclasses.replace(wide, depth=128),
                                     False)


@pytest.mark.parametrize("kernel", ["compressed", "mimt"])
def test_tracer_maps_inactive_rays_to_a_miss(kernel):
    """SceneTracer turns the wide kernels' sentinel (tri INACTIVE_TRI,
    t = -1) into the port's miss (tri -1, t = +inf), as K2 / K2c report
    inactive rays, in both modes; their visibility is 0 (occluded
    reports inactive rays so) and active rays hit."""
    data = port_scenes.cube_scene().build("cpu")
    t = SceneTracer.build(data, RenderSettings(trace_backend="pallas-wide",
                                               wide_kernel=kernel))
    R = 64
    o = torch.tensor([[0.0, 5.0, 0.0]]).repeat(R, 1)
    d = torch.tensor([[0.0, -1.0, 0.0]]).repeat(R, 1)
    act = torch.arange(R) % 2 == 0
    tm = torch.full((R,), 1e6)
    ct, ctri, cu, cv = t._closest(o, d, 0.01, tm, act)
    assert (ctri[~act] == -1).all() and torch.isinf(ct[~act]).all()
    assert (ctri[act] >= 0).all() and (ct[act] < 5.0).all()
    assert (cu[~act] == 0).all() and (cv[~act] == 0).all()
    assert (t._any(o, d, 0.01, tm, act)[~act] == -1).all()
    vis = t.occluded(o, d, 1e6, act)
    assert (vis[~act] == 0.0).all() and (vis[act] == 0.0).all()


def test_tile_major_matches_reference():
    """The wide kernels' ray order is the reference's to_tile_major (32x32
    tiles, edge-padded), and each pixel's traced position inverts it."""
    H, W = 40, 70
    img = np.arange(H * W, dtype=np.int32).reshape(H, W)
    ref, _ = ref_image.to_tile_major(jnp.asarray(img))
    fwd, pos = trace.tile_major(H, W, "cpu")
    np.testing.assert_array_equal(fwd.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(fwd[pos].numpy(), img.reshape(-1))
