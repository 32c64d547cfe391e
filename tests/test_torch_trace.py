"""Port vs reference: any-hit BVH traversal, the plain version of K2
(ops/trace_cuda.py), against the reference's SIMT traversal
(ops/trace.py intersect_bvh, backend "jnp") on the same SAH tree.
Any-hit returns any hit, so visibility (tri >= 0) is compared."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridrenderer_tpu.ops import bvh as ref_bvh
from hybridrenderer_tpu.ops import sampling as ref_sampling
from hybridrenderer_tpu.ops import trace as ref_trace
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu_torch.ops import trace_cuda
from hybridrenderer_tpu_torch.ops.trace import SceneTracer
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

from .torch_parity import flatten, one_torch_thread


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _rays(n, seed):
    g = np.random.default_rng(seed)
    o = g.uniform([-20, 0.05, -10], [20, 6, 10], (n, 3)).astype(np.float32)
    d = g.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = g.choice([10.0, 10000.0], size=n).astype(np.float32)
    active = g.random(n) < 0.9
    return o, d, tmax, active


def test_visibility_matches_reference():
    ref_data = ref_scenes.stress_scene(num_objects=8, seed=3).build()
    soup = ref_data.triangles
    tree = ref_bvh.build_bvh_host(soup.v0, soup.v1, soup.v2, "sah")
    o, d, tmax, active = _rays(4096, 0)
    # the reference's CPU backend passes inactive rays as tmax 0
    _, ref_tri, _, _ = ref_trace.intersect_bvh(
        tree, soup.v0, soup.v1, soup.v2, jnp.asarray(o), jnp.asarray(d),
        0.01, jnp.asarray(np.where(active, tmax, 0.0)), any_hit=True)
    tracer = SceneTracer.build(scene_from_numpy(flatten(ref_data), "cpu"))
    tri = trace_cuda.intersect_any(
        tracer.packed, torch.from_numpy(o), torch.from_numpy(d), 0.01,
        torch.from_numpy(tmax), torch.from_numpy(active)).numpy()
    ref_vis = np.asarray(ref_tri) >= 0
    assert 0.1 < ref_vis.mean() < 0.9
    # at most 0.1% of rays may flip, for grazing hits
    assert ((tri >= 0) != ref_vis).mean() <= 1e-3
    assert (tri[~active] == -1).all()


def test_shadow_query_matches_reference():
    """SceneTracer.shadow_query over an image: offset origins, tmin 0.01,
    tmax capped at 10000, background pixels masked out."""
    ref_data = ref_scenes.cube_scene().build()
    ref_tracer = ref_trace.SceneTracer.build(ref_data)
    tracer = SceneTracer.build(scene_from_numpy(flatten(ref_data), "cpu"))
    g = np.random.default_rng(7)
    H, W = 24, 40
    pos = np.zeros((H, W, 3), np.float32)
    pos[..., 0] = g.uniform(-4, 4, (H, W))
    pos[..., 2] = g.uniform(-4, 4, (H, W))
    nrm = np.zeros((H, W, 3), np.float32)
    nrm[..., 1] = 1.0
    active = g.random((H, W)) < 0.8
    sun = np.array([0.4, 0.8, 0.3], np.float32)
    sun /= np.linalg.norm(sun)
    ao = np.asarray(ref_sampling.interleaved_cos_hemisphere(
        3, jnp.asarray(nrm), block=8))
    for direction, tmax in ((np.broadcast_to(sun, (H, W, 3)), 1e10),
                            (ao, 10.0)):
        ref = np.asarray(ref_tracer.shadow_query(
            ref_data, jnp.asarray(pos), jnp.asarray(nrm),
            jnp.asarray(direction), tmax, active=jnp.asarray(active)))
        out = tracer.shadow_query(
            torch.from_numpy(pos), torch.from_numpy(nrm),
            torch.from_numpy(np.array(direction)), tmax,
            active=torch.from_numpy(active)).numpy()
        assert 0.0 < (ref[active] == 0.0).mean() < 1.0
        assert (out[active] != ref[active]).mean() <= 1e-3


def test_stack_covers_tree_depth():
    """pack_bvh refuses a tree deeper than the traversal stack holds, so
    no child is ever dropped; a chain of T leaves has depth T - 1."""
    def chain(T):
        inner = np.arange(T - 1)
        left = np.full(2 * T - 1, -1, np.int32)
        right = np.full(2 * T - 1, -1, np.int32)
        left[inner] = inner + 1
        left[T - 2] = 2 * T - 2
        right[inner] = T - 1 + inner
        return types.SimpleNamespace(left=torch.from_numpy(left),
                                     right=torch.from_numpy(right))

    assert trace_cuda.tree_depth(**vars(chain(5))) == 4
    deep = chain(trace_cuda.STACK_DEPTH + 1)
    with pytest.raises(ValueError, match="stack"):
        trace_cuda.pack_bvh(deep, None, None, None)
    ref_data = ref_scenes.stress_scene(num_objects=8, seed=3).build()
    tracer = SceneTracer.build(scene_from_numpy(flatten(ref_data), "cpu"))
    left = tracer.packed.nodes[:, 3].contiguous().view(torch.int32)
    right = tracer.packed.nodes[:, 7].contiguous().view(torch.int32)
    assert 10 < trace_cuda.tree_depth(left, right) < trace_cuda.STACK_DEPTH
