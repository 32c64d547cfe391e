"""Port vs reference: the bf16 wide-BVH records above the reference's
96 MiB budget (ops/bvh_wide.py _bf16_down, _bf16_up, quantize_bf16,
quantize_refit_device, quantize_triangles), the traversal over the
quantized triangles, and SceneTracer's kernel choice against the
reference tracer's (ops/trace.py plan_wide).

Budgets and the meta limit are monkeypatched low in both packages, so
that a small scene crosses each threshold; the reference's direct kernel
runs in Pallas interpret mode, as tests/test_bf16_records.py runs it."""
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
from hybridrenderer_tpu_torch.ops import bvh, bvh_wide, trace
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

from .torch_parity import clear_reference_knobs, flatten, one_torch_thread

# stress_scene(40): 11,414 triangles, f32 wide records 958,464 bytes,
# bf16 479,232, bf16 node records 122,880, meta table 9,832 bytes
BUDGETS = {"quantized": 600_000, "streamed": 300_000, "exact": 100_000}
# the share of rays whose hit may differ from the reference's direct
# kernel over its bf16 records: a triangle rounded to nearest can poke
# out of the reference's outward-rounded f32 box, which the port's boxes
# (built around the rounded triangles) contain (reading: 0 of 2,048
# random rays, both queries)
DIFFERING_RAYS_MAX = 0.005


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    clear_reference_knobs(monkeypatch)


@pytest.fixture(scope="module")
def stress40():
    ref_data = ref_scenes.stress_scene(num_objects=40).build()
    with one_torch_thread():
        data = scene_from_numpy(flatten(ref_data), "cpu")
    return ref_data, data


def _budget(monkeypatch, budget, meta=None):
    for mod in (trace_pallas, trace):
        monkeypatch.setattr(mod, "VMEM_SCENE_BUDGET", budget)
        if meta is not None:
            monkeypatch.setattr(mod, "META_SMEM_LIMIT", meta)


def test_outward_rounding_equals_reference():
    """_bf16_down / _bf16_up bit for bit on the reference test's inputs:
    random magnitudes over 12 decades, +-0, +-1, +-3e38, 255, 256."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(size=1000).astype(np.float32) * 10.0 ** rng.integers(
            -6, 6, 1000).astype(np.float32),
        np.float32([0.0, -0.0, 1.0, -1.0, 3e38, -3e38, 255.0, 256.0])])
    t = torch.from_numpy(x)
    bits = lambda b: b.view(torch.int16).numpy().view(np.uint16)
    for mine, ref in ((bvh_wide._bf16_down, ref_wide._bf16_down),
                      (bvh_wide._bf16_up, ref_wide._bf16_up)):
        np.testing.assert_array_equal(bits(mine(t)),
                                      ref(x).view(np.uint16))


def test_quantized_records_equal_reference(stress40):
    """quantize_bf16 and quantize_refit_device against the reference's on
    stress_scene(40): boxes and leaf geometry bit for bit, ids exact
    (the reference splits them into three byte rows); the quantized
    triangles equal the leaves' geometry."""
    _, data = stress40
    s = data.triangles
    with one_torch_thread():
        tree = bvh.build_sah(s.v0, s.v1, s.v2)
        wide = bvh_wide.build_wide(tree, s.v0, s.v1, s.v2)
        q = bvh_wide.quantize_bf16(wide)
        qn, ql = bvh_wide.quantize_refit_device(wide.nodes_flat,
                                                wide.leaves_flat)
        v0q, e1q, e2q = bvh_wide.quantize_triangles(s.v0, s.v1, s.v2)
    ref = ref_wide.build_wide(tree, *(x.numpy() for x in (s.v0, s.v1,
                                                          s.v2)))
    rq = ref_wide.quantize_bf16(ref)
    rn, rl = ref_wide.quantize_refit_device(jnp.asarray(ref.nodes),
                                            jnp.asarray(ref.leaves))
    assert q.quantized and q.vmem_bytes * 2 == wide.vmem_bytes
    assert q.vmem_bytes == rq.vmem_bytes
    flat = lambda a: np.asarray(a).astype(np.float32).transpose(
        0, 2, 1).reshape(-1, 48)
    for nodes, leaves in ((q.nodes_flat, q.leaves_flat), (qn, ql)):
        for ref_nodes, ref_leaves in ((rq.nodes, rq.leaves), (rn, rl)):
            np.testing.assert_array_equal(nodes.numpy().view(np.int32),
                                          flat(ref_nodes).view(np.int32))
            rl_f = flat(ref_leaves)
            for t in range(4):
                c = 12 * t
                np.testing.assert_array_equal(
                    leaves[:, c:c + 9].numpy().view(np.int32),
                    rl_f[:, c:c + 9].view(np.int32))
                ids = rl_f[:, c + 9] + 256.0 * rl_f[:, c + 10] \
                    + 65536.0 * rl_f[:, c + 11]
                mine = leaves[:, c + 9].numpy()
                np.testing.assert_array_equal(mine[mine >= 0],
                                              ids[mine >= 0])
                assert (rl_f[mine < 0, c + 9] < 0).all()
    # every bf16 value is exact in the f32 records
    assert torch.equal(q.nodes_flat.to(torch.bfloat16).float(), q.nodes_flat)
    ct = wide.cluster_tri.long()
    ok = ct >= 0
    for t in range(4):
        tid = ct[:, t][ok[:, t]]
        rows = q.leaves_flat[ok[:, t]]
        for k, x in enumerate((v0q, e1q, e2q)):
            assert torch.equal(rows[:, 12 * t + 3 * k:12 * t + 3 * k + 3],
                               x[tid])


@pytest.mark.parametrize("any_hit", [True, False])
def test_quantized_traversal_matches_reference(stress40, monkeypatch,
                                               any_hit):
    """With the budget below the f32 records, the reference's direct
    kernel traces its bf16 records and the port's K2 / K2c (plain
    versions) its rounded triangles in boxes that hold them: 2,048
    random rays, the same hits but at most DIFFERING_RAYS_MAX of rays; on
    equal triangles t, u and v within 2e-5 (the kernels' association,
    as tests/test_trace_direct.py holds the f32 kernel to the jnp one);
    the port's refit of the unmoved scene traces the same."""
    ref_data, data = stress40
    _budget(monkeypatch, BUDGETS["quantized"])
    rt = ref_trace.SceneTracer.build(
        ref_data, RefSettings(trace_backend="pallas-wide"))
    with one_torch_thread():
        pt = trace.SceneTracer.build(
            data, RenderSettings(trace_backend="pallas-wide"))
        refit = pt.refit(data)
    assert rt.wide_nodes.dtype == jnp.bfloat16 and pt.quantized
    rng = np.random.default_rng(7)
    R = 2048
    v0 = np.asarray(ref_data.triangles.v0)
    o = rng.uniform(v0.min(0) - 1, v0.max(0) + 1, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = [np.asarray(x) for x in trace_pallas.intersect_wide_direct(
        rt.wide_nodes, rt.wide_leaves, rt.wide_meta_tiles, jnp.asarray(o),
        jnp.asarray(d), 1e-3, 1e4, any_hit=any_hit, interpret=True)]
    args = (torch.from_numpy(o), torch.from_numpy(d), 1e-3,
            torch.full((R,), 1e4), torch.ones(R, dtype=torch.bool))
    for tracer in (pt, refit):
        with one_torch_thread():
            out = tracer._any(*args) if any_hit else tracer._closest(*args)
        if any_hit:
            hit = out.numpy() >= 0
            differ = hit != (ref[1] >= 0)
        else:
            t, tri, u, v = (x.numpy() for x in out)
            hit = tri >= 0
            differ = tri != ref[1]
            same = hit & ~differ
            for mine, theirs in ((t, ref[0]), (u, ref[2]), (v, ref[3])):
                np.testing.assert_allclose(mine[same], theirs[same],
                                           rtol=2e-5, atol=2e-5)
        assert 0.2 < hit.mean() < 0.9
        assert differ.mean() <= DIFFERING_RAYS_MAX, int(differ.sum())


def _ref_choice(tracer):
    """The reference tracer's kernel and records, in the port's terms."""
    if tracer.backend == "jnp":
        return "exact", None, False
    kernel = "mimt" if tracer.wide_nodes_p8 is not None else \
        None if tracer.wide_meta_tiles is not None else "compressed"
    return "pallas-wide", kernel, tracer.wide_nodes.dtype == jnp.bfloat16


@pytest.mark.parametrize("budget,meta", [
    ("quantized", None), ("streamed", None), ("exact", None),
    ("quantized", 5000), (None, 5000)])
def test_kernel_choice_equals_reference(stress40, monkeypatch, budget,
                                        meta):
    """For each wide_kernel, with the budget below the f32 records, the
    bf16 records or even the bf16 node records, and with the meta limit
    below the meta table: the port's choice (K2 / K2c, K2w or K2m; bf16
    triangles or not; the exact fallback) equals the reference tracer's
    (backend, wide_meta_tiles, wide_nodes_p8, the records' dtype)."""
    ref_data, data = stress40
    if budget is not None:
        _budget(monkeypatch, BUDGETS[budget], meta)
    elif meta is not None:
        for mod in (trace_pallas, trace):
            monkeypatch.setattr(mod, "META_SMEM_LIMIT", meta)
    for kernel, stack, ref_kernel in ((None, "auto", "packet"),
                                      ("compressed", "compressed", "packet"),
                                      ("mimt", "auto", "mimt")):
        monkeypatch.setattr(trace_pallas, "WIDE_STACK", stack)
        monkeypatch.setattr(trace_pallas, "WIDE_KERNEL", ref_kernel)
        rt = ref_trace.SceneTracer.build(
            ref_data, RefSettings(trace_backend="pallas-wide"))
        with one_torch_thread():
            pt = trace.SceneTracer.build(data, RenderSettings(
                trace_backend="pallas-wide", wide_kernel=kernel))
        backend = "exact" if pt.backend == "jnp" else pt.backend
        assert (backend, pt.wide_kernel, pt.quantized) == _ref_choice(rt), \
            (kernel, pt.demotion)
        assert (pt.demotion is None) == (pt.wide_kernel == kernel
                                         and backend != "exact")
        if pt.wide_kernel is None:
            assert pt.wide is None and pt.packed is not None
        else:
            assert pt.wide.quantized == pt.quantized


@pytest.mark.parametrize("kernel", [None, "compressed"])
def test_quantized_dynamic_frame_capturable(monkeypatch, kernel):
    """A dynamic full-graph frame over bf16 triangles (the budget
    monkeypatched between the cube's bf16 and f32 records: K2 / K2c over
    the rounded triangles, or K2w over the bf16 records) and the
    quantized shade rows: the transform update, the refit that rounds
    the moved triangles again, the side table's refresh and the frame
    make no host sync and copy no host data (tests/torch_capture.py), so
    they run inside the captured commit and frame graphs."""
    from hybridrenderer_tpu_torch.core.types import RenderFlags
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer
    from hybridrenderer_tpu_torch.scene import schema
    from hybridrenderer_tpu_torch.scene import scene as port_scenes
    from hybridrenderer_tpu_torch.scene.dynamic import DynamicScene

    from .test_torch_runtime import _hybrid, _lint_frames

    monkeypatch.setattr(trace, "VMEM_SCENE_BUDGET", 30_000)
    host = port_scenes.cube_scene()
    with one_torch_thread():
        data = host.build("cpu")
        data.shade_rows_q = schema.build_shade_rows_q(
            data.vertices, data.instances, data.triangles)
        data.inst_shade = schema.build_inst_shade(data.instances,
                                                  data.materials)
        s = _hybrid(32, trace_backend="pallas-wide", wide_kernel=kernel)
        r = Renderer.for_scene(s.replace(
            flags=s.flags | RenderFlags.REFLECTION | RenderFlags.GI), data)
        assert r.tracer.quantized and r.tracer.wide_kernel == kernel
        found = _lint_frames(r, DynamicScene(host, r))
    assert not found, sorted(set(found))
