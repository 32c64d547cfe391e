"""Port vs reference: the wide tree's shapes, ``bvh_width`` 8 or 16 and
``bvh_leaf_tris`` 4, 8 or 16 (ops/bvh_wide.py build_wide, refit_wide;
ops/trace.py plan_wide), and K2w's plain version over 8- and
16-triangle leaf clusters against the per-ray traversal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridrenderer_tpu.core.config import RenderSettings as RefSettings
from hybridrenderer_tpu.ops import bvh_wide as ref_wide
from hybridrenderer_tpu.ops import trace as ref_trace
from hybridrenderer_tpu.ops import trace_pallas
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.ops import bvh, bvh_wide, trace, trace_cuda
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

from .test_torch_wide import _moved, _rays
from .torch_parity import clear_reference_knobs, flatten, one_torch_thread

RECORDS = ("nodes_flat", "leaves_flat", "meta", "slot_child_bin",
           "cluster_tri")
# (bvh_width, bvh_leaf_tris) besides the default (8, 4)
SHAPES = [(8, 8), (8, 16), (16, 4)]


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    clear_reference_knobs(monkeypatch)


@pytest.fixture(scope="module")
def stress12():
    """stress_scene(12): 3,182 triangles, both packages' data, and the
    port's SAH tree over them."""
    ref_data = ref_scenes.stress_scene(num_objects=12).build()
    with one_torch_thread():
        data = scene_from_numpy(flatten(ref_data), "cpu")
        s = data.triangles
        tree = bvh.build_sah(s.v0, s.v1, s.v2)
    return ref_data, data, tree


@pytest.mark.parametrize("width,leaf_tris", SHAPES)
def test_build_wide_shapes_equal_reference(stress12, width, leaf_tris):
    """The port's records, meta table (unpacked (Nw, 4) 16 wide) and
    refit maps equal the reference build_wide's bit for bit at each
    shape, and so does vmem_bytes, which plan_wide reads; every triangle
    sits in exactly one cluster."""
    _, data, tree = stress12
    s = data.triangles
    v = (s.v0, s.v1, s.v2)
    with one_torch_thread():
        wide = bvh_wide.build_wide(tree, *v, leaf_tris=leaf_tris, width=width)
    ref = ref_wide.build_wide(tree, *(x.numpy() for x in v),
                              leaf_tris=leaf_tris, width=width)
    for f in RECORDS:
        np.testing.assert_array_equal(getattr(wide, f).numpy(),
                                      getattr(ref, f), err_msg=f)
    assert (wide.width, wide.leaf_tris) == (width, leaf_tris)
    assert wide.meta.shape[1] == (2 if width == 8 else 4)
    assert (wide.num_wide, wide.num_clusters) == (ref.num_wide,
                                                   ref.num_clusters)
    assert wide.vmem_bytes == ref.vmem_bytes
    assert bvh_wide.validate_wide(wide, s.v0)


def test_build_wide_refuses_other_widths(stress12):
    _, data, tree = stress12
    s = data.triangles
    with pytest.raises(ValueError, match="width"):
        bvh_wide.build_wide(tree, s.v0, s.v1, s.v2, width=4)


def test_refit_wide_8_tris_equals_reference(stress12):
    """refit_wide over an 8-triangle-cluster tree after the triangles
    move equals the reference's refit_wide and a fresh build over the
    refit binary tree."""
    _, data, tree = stress12
    s = data.triangles
    v = [s.v0, s.v1, s.v2]
    mv = _moved(v, 1.5)
    with one_torch_thread():
        port = bvh.refit_bvh(tree, *mv, bvh.refit_levels(tree))
        wide = bvh_wide.build_wide(tree, *v, leaf_tris=8)
        refit = bvh_wide.refit_wide(wide, port.node_min, port.node_max, *mv)
        fresh = bvh_wide.build_wide(port, *mv, leaf_tris=8)
    scb, ct = (jnp.asarray(getattr(wide, f).numpy())
               for f in ("slot_child_bin", "cluster_tri"))
    _, _, rnodes, rleaves = ref_wide.refit_wide(
        scb, ct, jnp.asarray(port.node_min.numpy()),
        jnp.asarray(port.node_max.numpy()),
        *(jnp.asarray(x.numpy()) for x in mv))
    np.testing.assert_array_equal(refit.nodes_flat.numpy(),
                                  np.asarray(rnodes))
    np.testing.assert_array_equal(refit.leaves_flat.numpy(),
                                  np.asarray(rleaves))
    np.testing.assert_array_equal(refit.nodes_flat, fresh.nodes_flat)
    np.testing.assert_array_equal(refit.leaves_flat, fresh.leaves_flat)


def _ref_choice(tracer):
    """The reference tracer's kernel and records, in the port's terms."""
    if tracer.backend == "jnp":
        return "exact", None, False
    kernel = "mimt" if tracer.wide_nodes_p8 is not None else \
        None if tracer.wide_meta_tiles is not None else "compressed"
    return "pallas-wide", kernel, tracer.wide_nodes.dtype == jnp.bfloat16


def _limits(wide, case):
    """(record budget, meta limit) between the thresholds of this tree's
    records: below its f32 records, its bf16 records or even its bf16
    node records; or the meta limit below its meta table."""
    f32 = wide.vmem_bytes
    nodes16 = 2 * wide.nodes_flat.numel()
    return {"f32": (None, None), "quantized": ((f32 // 2 + f32) // 2, None),
            "streamed": ((nodes16 + f32 // 2) // 2, None),
            "exact": (nodes16 // 2, None),
            "meta": (None, 4 * wide.meta.numel() - 4)}[case]


@pytest.mark.parametrize("case", ["f32", "quantized", "streamed", "exact",
                                  "meta"])
@pytest.mark.parametrize("width,leaf_tris", [(8, 4)] + SHAPES)
def test_plan_wide_equals_reference(stress12, monkeypatch, width, leaf_tris,
                                    case):
    """At each shape, for each wide_kernel, with the record budget or the
    meta limit monkeypatched between this tree's thresholds in both
    packages: the port's choice (K2 / K2c, K2w or K2m; bf16 triangles or
    not; the exact fallback) equals the reference tracer's. 16 wide, or
    with clusters of other than 4 triangles, the reference demotes
    "compressed" and "mimt" (ops/trace.py:304-320)."""
    ref_data, data, tree = stress12
    s = data.triangles
    with one_torch_thread():
        wide = bvh_wide.build_wide(tree, s.v0, s.v1, s.v2,
                                   leaf_tris=leaf_tris, width=width)
    budget, meta = _limits(wide, case)
    for mod in (trace_pallas, trace):
        if budget is not None:
            monkeypatch.setattr(mod, "VMEM_SCENE_BUDGET", budget)
        if meta is not None:
            monkeypatch.setattr(mod, "META_SMEM_LIMIT", meta)
    shape = dict(bvh_width=width, bvh_leaf_tris=leaf_tris)
    for kernel, stack, ref_kernel in ((None, "auto", "packet"),
                                      ("compressed", "compressed", "packet"),
                                      ("mimt", "auto", "mimt")):
        monkeypatch.setattr(trace_pallas, "WIDE_STACK", stack)
        monkeypatch.setattr(trace_pallas, "WIDE_KERNEL", ref_kernel)
        rt = ref_trace.SceneTracer.build(
            ref_data, RefSettings(trace_backend="pallas-wide", **shape))
        with one_torch_thread():
            pt = trace.SceneTracer.build(data, RenderSettings(
                trace_backend="pallas-wide", wide_kernel=kernel, **shape))
        backend = "exact" if pt.backend == "jnp" else pt.backend
        assert (backend, pt.wide_kernel, pt.quantized) == _ref_choice(rt), \
            (kernel, pt.demotion)
        assert (pt.demotion is None) == (pt.wide_kernel == kernel
                                         and backend != "exact")
        assert pt.wide_bytes == wide.vmem_bytes
        if pt.wide_kernel is not None:
            assert (pt.wide.width, pt.wide.leaf_tris) == (width, leaf_tris)
        if width == 16 and kernel is not None:
            assert pt.wide_kernel is None


@pytest.mark.parametrize("leaf_tris", [8, 16])
def test_wide_plain_leaf_clusters_match_per_ray(stress12, leaf_tris):
    """K2w's plain version over 8- and 16-triangle clusters, 2,048 rays
    with an active mask and a per-ray tmax, against the per-ray K2 / K2c
    plain versions over the binary tree: any-hit visibility equal,
    closest-hit triangle ids and t equal (the same triangle tests in the
    same arithmetic); inactive rays report the sentinel."""
    _, data, tree = stress12
    s = data.triangles
    v = (s.v0, s.v1, s.v2)
    o, d, tmax, act = (torch.from_numpy(x) for x in _rays(s.v0, 2048, 5))
    with one_torch_thread():
        wide = bvh_wide.build_wide(tree, *v, leaf_tris=leaf_tris)
        packed = trace_cuda.pack_bvh(tree, *v)
        vis = trace_cuda.intersect_wide(wide, o, d, 1e-3, tmax, act,
                                        True)[1]
        t, tri, _, _ = trace_cuda.intersect_wide(wide, o, d, 1e-3, tmax,
                                                 act, False)
        ref_vis = trace_cuda.intersect_any(packed, o, d, 1e-3, tmax, act)
        ref_t, ref_tri, _, _ = trace_cuda.intersect_closest(
            packed, o, d, 1e-3, tmax, act)
    hit = (vis >= 0) & (vis != trace_cuda.INACTIVE_TRI)
    assert torch.equal(hit, ref_vis >= 0)
    assert torch.equal(tri[act], ref_tri[act])
    assert torch.equal(t[act], ref_t[act])
    assert (tri[~act] == trace_cuda.INACTIVE_TRI).all()
    assert 0.1 < hit.float().mean() < 0.9


def test_wide_kernels_refuse_other_shapes(stress12):
    """K2m takes 4-triangle clusters only, and both wide traversals
    8-wide trees only, as the reference's kernels (which it demotes)."""
    _, data, tree = stress12
    s = data.triangles
    o, d, tmax, act = (torch.from_numpy(x) for x in _rays(s.v0, 64, 1))
    with one_torch_thread():
        w16 = bvh_wide.build_wide(tree, s.v0, s.v1, s.v2, width=16)
    with pytest.raises(ValueError, match="8-wide"):
        trace_cuda.intersect_wide(w16, o, d, 1e-3, tmax, act, True)
    with pytest.raises(ValueError, match="8-wide"):
        trace_cuda.intersect_mimt(w16, o, d, 1e-3, tmax, act, True)
