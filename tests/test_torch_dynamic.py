"""Port vs reference: dynamic scenes (scene/dynamic.py): the topology
maps, the full and dirty-only transform updates field by field, the
tracer's refit, and a dynamic render through the wide kernels K2w and
K2m (their plain versions, on the CPU) against the reference's."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hybridrenderer_tpu.core.camera import OrbitCamera as RefCamera
from hybridrenderer_tpu.core.types import RenderFlags as RefFlags
from hybridrenderer_tpu.scene import dynamic as ref_dynamic
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType
from hybridrenderer_tpu_torch.ops.trace import SHADE_COLS, SceneTracer
from hybridrenderer_tpu_torch.runtime.output import to_u8
from hybridrenderer_tpu_torch.runtime.renderer import Renderer
from hybridrenderer_tpu_torch.scene import dynamic
from hybridrenderer_tpu_torch.scene import scene as port_scenes

from .test_torch_slice import (CASES, SVGF_FLAGS, _edge_tri_ids,
                               reference_renderer)
from .torch_parity import (clear_reference_knobs, off_edge_errors,
                           one_torch_thread)

MAPS = ("vertex_instance", "local_lo", "local_hi", "instance_entity",
        "cdf_tri", "cdf_seg_start")


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    clear_reference_knobs(monkeypatch)
    with one_torch_thread():
        yield


def _translate(x, y, z):
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = [x, y, z]
    return t


def _rotate_y(a, at):
    c, s = np.cos(a), np.sin(a)
    r = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
                 np.float32)
    return (_translate(*at) @ r).astype(np.float32)


def _moved_transforms(host, maps_entity):
    """Cornell's instance transforms with the cube (entity 6) turned and
    the emissive ceiling quad (entity 5) lowered and stretched, which
    changes its triangles' areas and so the light CDF."""
    tf = np.stack([r[1] for r in host._built["rows"]]).astype(np.float32)
    ent = np.asarray(maps_entity)
    tf[ent == 6] = _rotate_y(0.4, (-0.8, 0.75, -0.3))
    stretch = np.diag([1.25, 1.0, 1.2, 1.0]).astype(np.float32)
    tf[ent == 5] = _translate(0.0, -0.2, 0.0) @ stretch @ tf[ent == 5][0]
    return tf


class _Host:
    """A renderer stand-in: DynamicScene needs its scene and tracer."""

    def __init__(self, scene):
        self.scene, self.tracer = scene, None


@pytest.fixture(scope="module")
def cornell():
    ref_host = ref_scenes.cornell_scene()
    ref_data = ref_host.build()
    host = port_scenes.cornell_scene()
    data = host.build("cpu")
    return ref_host, ref_data, host, data


def test_maps_and_ranges_equal_reference(cornell):
    ref_host, _, host, _ = cornell
    ref_maps, maps = ref_dynamic.build_maps(ref_host), dynamic.build_maps(
        host, "cpu")
    for f in MAPS:
        np.testing.assert_array_equal(getattr(maps, f).numpy(),
                                      np.asarray(getattr(ref_maps, f)), f)
    ref_rg, rg = ref_dynamic.build_host_ranges(ref_host), \
        dynamic.build_host_ranges(host)
    assert ref_rg.keys() == rg.keys()
    for k in rg:
        if k == "first_inst":
            assert rg[k] == ref_rg[k]
        else:
            np.testing.assert_array_equal(rg[k], ref_rg[k], k)


@pytest.mark.parametrize("mode", ["full", "subset"])
def test_update_transforms_matches_reference(cornell, mode):
    """Field by field against the reference's update (its full re-bake in
    both cases: the reference pads its dirty rows to 4096, which is more
    than half of cornell's 1,048 triangles). Exact: the transforms. Within
    2e-6: the world positions, the soup and the world boxes (the
    rotation's 3-term sums in einsum: XLA and PyTorch round 2 of 3,144
    soup coordinates 1 ulp apart), the inverses (torch.linalg.inv_ex and
    jnp.linalg.inv round apart), and through them the attribute and
    raster rows; the light CDF (the emissive quad moved) to 1e-6
    relative."""
    ref_host, ref_data, host, data = cornell
    ref_maps, maps = ref_dynamic.build_maps(ref_host), dynamic.build_maps(
        host, "cpu")
    tf = _moved_transforms(host, maps.instance_entity)
    ref = ref_dynamic.update_transforms(ref_data, ref_maps, jnp.asarray(tf))
    if mode == "full":
        out = dynamic.update_transforms(data, maps, torch.from_numpy(tf))
    else:
        dyn = dynamic.DynamicScene(host, _Host(data))
        for e in (5, 6):
            row = np.flatnonzero(np.asarray(maps.instance_entity) == e)[0]
            dyn.set_entity_transform(e, tf[row])
        vert_idx, tri_idx, lights = dyn._dirty_indices(frozenset({5, 6}))
        assert lights and 0 < tri_idx.shape[0] <= data.num_triangles // 2
        out = dynamic.update_transforms_subset(
            data, maps, torch.from_numpy(dyn._transforms), vert_idx,
            tri_idx, update_lights=lights)
    for f in ("transform", "prev_transform"):
        np.testing.assert_array_equal(getattr(out.instances, f).numpy(),
                                      np.asarray(getattr(ref.instances, f)),
                                      f)
    close = {f: (getattr(out.instances, f), getattr(ref.instances, f))
             for f in ("inverse_transform", "normal_transform", "aabb_min",
                       "aabb_max")}
    for f in ("v0", "v1", "v2"):
        close[f] = (getattr(out.triangles, f), getattr(ref.triangles, f))
    close["world_position"] = (out.vertices.world_position,
                               ref.vertices.world_position)
    close["attr_rows"] = (out.attr_rows, ref.attr_rows)
    close["raster_rows"] = (out.raster_rows, ref.raster_rows)
    for name, (a, b) in close.items():
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6,
                                   atol=2e-6, err_msg=name)
    np.testing.assert_allclose(out.lights.cdf.numpy(),
                               np.asarray(ref.lights.cdf), rtol=1e-6)
    assert not np.array_equal(out.lights.cdf.numpy(),
                              data.lights.cdf.numpy())


def test_subset_update_equals_full_update(cornell):
    """The dirty-only update gives exactly the full update's SceneData,
    the subset attribute and raster rows included."""
    _, _, host, data = cornell
    maps = dynamic.build_maps(host, "cpu")
    tf = _moved_transforms(host, maps.instance_entity)
    full = dynamic.update_transforms(data, maps, torch.from_numpy(tf))
    dyn = dynamic.DynamicScene(host, _Host(data))
    for e in (5, 6):
        dyn.set_entity_transform(e, tf[np.flatnonzero(
            np.asarray(maps.instance_entity) == e)[0]])
    sub = dynamic.update_transforms_subset(
        data, maps, torch.from_numpy(dyn._transforms),
        *dyn._dirty_indices(frozenset({5, 6}))[:2], update_lights=True)
    for a, b in ((sub.triangles.v0, full.triangles.v0),
                 (sub.triangles.v2, full.triangles.v2),
                 (sub.vertices.world_position, full.vertices.world_position),
                 (sub.attr_rows, full.attr_rows),
                 (sub.raster_rows, full.raster_rows),
                 (sub.lights.cdf, full.lights.cdf),
                 (sub.instances.normal_transform,
                  full.instances.normal_transform)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", [None, "compressed", "mimt"])
def test_refit_tracer_equals_fresh_build(cornell, kernel):
    """SceneTracer.refit after a move: the same visibility and closest t
    as a tracer built from scratch on the moved scene, K2's depth kept,
    the shading rows taken from the new attribute rows."""
    _, _, host, data = cornell
    maps = dynamic.build_maps(host, "cpu")
    s = RenderSettings(trace_backend="pallas-wide", wide_kernel=kernel)
    tracer = SceneTracer.build(data, s)
    moved = dynamic.update_transforms(data, maps, torch.from_numpy(
        _moved_transforms(host, maps.instance_entity)))
    refit, fresh = tracer.refit(moved), SceneTracer.build(moved, s)
    cols = torch.tensor(SHADE_COLS)
    assert torch.equal(refit.shade_rows, moved.attr_rows[:, cols])
    assert not torch.equal(refit.shade_rows, tracer.shade_rows)
    if kernel is None:
        assert refit.packed.depth == tracer.packed.depth
    g = np.random.default_rng(5)
    o = torch.from_numpy(g.uniform([-2.4, 0.1, -2.4], [2.4, 4.9, 2.4],
                                   (2048, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(
        g.standard_normal((2048, 3)).astype(np.float32)), dim=-1)
    tm = torch.full((2048,), 1e6)
    act = torch.ones(2048, dtype=torch.bool)
    a, b = refit._closest(o, d, 0.01, tm, act), fresh._closest(o, d, 0.01,
                                                               tm, act)
    assert torch.equal(a[1] >= 0, b[1] >= 0)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)


FRAMES = 3


def _dynamic_frames(kernel, flags, size=64):
    """The port's dynamic cube run: entity 1 translated before each of 3
    frames, through DynamicScene.commit()."""
    host = port_scenes.cube_scene()
    s = RenderSettings(width=size, height=size, path=RenderPathType.HYBRID,
                       flags=flags, ao_block=8, gi_block=8,
                       trace_backend="pallas-wide", wide_kernel=kernel)
    r = Renderer.for_scene(s, host.build("cpu"))
    dyn = dynamic.DynamicScene(host, r)
    cam = OrbitCamera(width=size, height=size, **CASES["cube"][1])
    for i in range(FRAMES):
        dyn.set_entity_transform(1, _translate(0.3 * i, 0.75, 0.1 * i))
        dyn.commit()
        img = to_u8(r.render_np(cam.step()))
    assert int(r.tracer.wide.deep_pushes) == 0
    return img


@pytest.fixture(scope="module")
def reference_dynamic():
    """The reference's dynamic cube run on its CPU paths (trace backend
    "jnp": visibility does not depend on the traversal), SVGF on and off:
    (images, the last frame's triangle ids for the edge mask)."""
    out = {}
    for svgf in (True, False):
        host = ref_scenes.cube_scene()
        data = host.build()
        flags = RefFlags.default_hybrid() if svgf else \
            RefFlags.default_hybrid() & ~SVGF_FLAGS
        r = reference_renderer(data, 64, flags)
        dyn = ref_dynamic.DynamicScene(host, r)
        cam = RefCamera(width=64, height=64, **CASES["cube"][1])
        for i in range(FRAMES):
            dyn.set_entity_transform(1, _translate(0.3 * i, 0.75, 0.1 * i))
            dyn.commit()
            state = cam.step()
            img = to_u8(np.asarray(r.render(state)))
        out[svgf] = (img, _edge_tri_ids(r.scene, state, 64))
    return out


@pytest.mark.parametrize("kernel", ["compressed", "mimt"])
@pytest.mark.parametrize("svgf", [True, False])
def test_dynamic_render_matches_reference(reference_dynamic, kernel, svgf):
    """64x64 cube, 3 frames, entity 1 moving: the port through K2w / K2m
    over the refit wide tree against the reference, at
    tests/test_torch_slice.py's hybrid gates: with SVGF the cube's 24 / 8
    (the reference's own jit-vs-eager chaos plus margin), without it
    2 / 1 off edges."""
    flags = RenderFlags.default_hybrid()
    if not svgf:
        flags &= ~(RenderFlags.SVGF | RenderFlags.SVGF_TEMPORAL
                   | RenderFlags.SVGF_SPATIAL)
    img = _dynamic_frames(kernel, flags)
    ref_img, tri = reference_dynamic[svgf]
    off_max, p99 = off_edge_errors(img, ref_img, tri)
    gate = CASES["cube"][2:] if svgf else (2, 1.0)
    assert off_max <= gate[0] and p99 <= gate[1], (off_max, p99)


def test_commit_and_render_equals_commit_then_render():
    """Renderer.render_dynamic, given the dirty set's update arguments,
    and DynamicScene.commit_and_render (which runs it) are the same
    update, refit and frame as commit(); render(): equal images, and the
    same scene and tracer left on the renderer."""
    size = 32

    def run(mode):
        host = port_scenes.cube_scene()
        s = RenderSettings(width=size, height=size,
                           path=RenderPathType.HYBRID,
                           flags=RenderFlags.default_hybrid(),
                           trace_backend="pallas-wide", wide_kernel="mimt")
        r = Renderer.for_scene(s, host.build("cpu"))
        dyn = dynamic.DynamicScene(host, r)
        cam = OrbitCamera(width=size, height=size, **CASES["cube"][1])
        imgs = []
        for i in range(3):
            dyn.set_entity_transform(1, _translate(0.4 * i, 0.75, 0.0))
            if mode == "fused":
                tf, vert_idx, tri_idx, use_subset, lights = dyn._pending()
                dyn._dirty_entities.clear()
                imgs.append(r.render_dynamic(cam.step(), dyn.maps, tf,
                                             vert_idx, tri_idx, use_subset,
                                             lights))
            elif mode == "commit_and_render":
                imgs.append(dyn.commit_and_render(cam.step()))
            else:
                dyn.commit()
                imgs.append(r.render(cam.step()))
        return imgs, r

    a, ra = run("commit")
    for mode in ("fused", "commit_and_render"):
        b, rb = run(mode)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert torch.equal(ra.scene.raster_rows, rb.scene.raster_rows)
        assert torch.equal(ra.tracer.wide.nodes_flat,
                           rb.tracer.wide.nodes_flat)
        assert torch.equal(ra.tracer.shade_rows, rb.tracer.shade_rows)
