"""Port vs reference: the LBVH builder (bvh_builder="lbvh"), bound from
the same native/bvh_builder.cpp (hrtpu_build_lbvh), a frame traced over
it, and the level refit of an LBVH tree against the reference's
range-minimum refit (refit_plan / refit_bvh_rmq), which the port does
not port because it gives the same exact boxes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridrenderer_tpu.core.camera import OrbitCamera as RefCamera
from hybridrenderer_tpu.core.config import RenderSettings as RefSettings
from hybridrenderer_tpu.core.types import DisplayMode as RefDisplayMode
from hybridrenderer_tpu.core.types import RenderFlags as RefFlags
from hybridrenderer_tpu.core.types import RenderPathType as RefPath
from hybridrenderer_tpu.ops import bvh as ref_bvh
from hybridrenderer_tpu.runtime.renderer import Renderer as RefRenderer
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.core.types import DisplayMode, RenderFlags
from hybridrenderer_tpu_torch.ops import bvh
from hybridrenderer_tpu_torch.runtime.output import to_u8
from hybridrenderer_tpu_torch.runtime.renderer import Renderer
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

from .test_torch_slice import (CORNELL_CAM, SVGF_FLAGS, _edge_tri_ids,
                               _settings)
from .torch_parity import (clear_reference_knobs, flatten, off_edge_errors,
                           one_torch_thread)

FIELDS = ("node_min", "node_max", "left", "right", "tri")


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    clear_reference_knobs(monkeypatch)


def _soup(scene_fn):
    s = scene_fn().build().triangles
    return [np.array(x) for x in (s.v0, s.v1, s.v2)]


@pytest.mark.parametrize("name", ["cornell", "stress25"])
def test_lbvh_equals_reference(name):
    """The port's LBVH node arrays equal the reference's
    build_bvh_host(builder="lbvh") bit for bit; an unknown builder
    raises."""
    scene_fn = {"cornell": ref_scenes.cornell_scene,
                "stress25": lambda: ref_scenes.stress_scene(
                    num_objects=25)}[name]
    v = _soup(scene_fn)
    ref = ref_bvh.build_bvh_host(*v, builder="lbvh")
    mine = bvh.build_bvh(*(torch.from_numpy(x) for x in v), "lbvh")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(mine, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
    sah = bvh.build_sah(*(torch.from_numpy(x) for x in v))
    assert not torch.equal(sah.left, mine.left)
    with pytest.raises(ValueError, match="builder"):
        bvh.build_bvh(*(torch.from_numpy(x) for x in v), "binned")


def test_level_refit_equals_reference_rmq_on_lbvh():
    """A moved LBVH scene (every vertex displaced by seeded noise): the
    port's level refit gives the reference's refit_bvh_rmq boxes bit for
    bit, and both equal a fresh box union (the topology kept)."""
    v = _soup(lambda: ref_scenes.stress_scene(num_objects=25))
    tree = ref_bvh.build_bvh_host(*v, builder="lbvh")
    rng = np.random.default_rng(3)
    moved = [(x + rng.normal(0, 0.05, x.shape)).astype(np.float32)
             for x in v]
    rows, K = ref_bvh.refit_plan(tree.left, tree.right, v[0].shape[0])
    ref = ref_bvh.refit_bvh_rmq(tree, *(jnp.asarray(x) for x in moved),
                                jnp.asarray(rows), K)
    port_tree = bvh.BVH(*(torch.from_numpy(np.array(getattr(tree, f)))
                          for f in FIELDS), num_tris=v[0].shape[0])
    mine = bvh.refit_bvh(port_tree, *(torch.from_numpy(x) for x in moved),
                         bvh.refit_levels(port_tree))
    for f in ("node_min", "node_max"):
        np.testing.assert_array_equal(getattr(mine, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
    leaf = mine.tri[v[0].shape[0] - 1:].long()
    corners = torch.stack([torch.from_numpy(x)[leaf] for x in moved])
    assert torch.equal(mine.node_min[0], corners.amin(dim=(0, 1)))
    assert torch.equal(mine.node_max[0], corners.amax(dim=(0, 1)))


def test_lbvh_frame_matches_reference():
    """The hybrid frame's raw shadow signal (SVGF off, SHADOW display
    mode, one 64x64 cornell frame) traced over the LBVH in both packages
    (the reference's jnp traversal): 2 u8 off edges, p99 1, as
    tests/test_torch_slice.py holds it over the SAH tree."""
    size = 64
    ref_data = ref_scenes.cornell_scene().build()
    ref = RefRenderer.for_scene(
        RefSettings(width=size, height=size, path=RefPath.HYBRID,
                    flags=RefFlags.default_hybrid() & ~SVGF_FLAGS,
                    display_mode=RefDisplayMode.SHADOW, ao_block=8,
                    gi_block=8, raster_backend="jnp", trace_backend="jnp",
                    svgf_backend="jnp", svgf_temporal_gather="pixel",
                    bvh_builder="lbvh"), ref_data)
    s = _settings(size, display_mode=DisplayMode.SHADOW,
                  bvh_builder="lbvh").replace(
        flags=RenderFlags.default_hybrid() & ~(
            RenderFlags.SVGF | RenderFlags.SVGF_TEMPORAL
            | RenderFlags.SVGF_SPATIAL))
    with one_torch_thread():
        port = Renderer.for_scene(s, scene_from_numpy(flatten(ref_data),
                                                      "cpu"))
        assert port.tracer.request[2] == "lbvh"
        img = to_u8(port.render_np(OrbitCamera(width=size, height=size,
                                               **CORNELL_CAM).step()))
    ref_state = RefCamera(width=size, height=size, **CORNELL_CAM).step()
    ref_img = to_u8(np.asarray(ref.render(ref_state)))
    assert ref_img.std() > 0.0
    off_max, p99 = off_edge_errors(
        img, ref_img, _edge_tri_ids(ref_data, ref_state, size))
    assert off_max <= 2 and p99 <= 1.0, (off_max, p99)
    # a changed builder rebuilds the tracer, as the reference's settings
    # take effect
    tracer = port.tracer
    port.apply_settings(bvh_builder="sah")
    assert port.tracer is not tracer and port.tracer.request[2] == "sah"
