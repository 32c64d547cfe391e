"""Port vs reference: the quantized hit-shading rows above 98,304
triangles (scene/schema.py build_shade_rows_q, build_inst_shade,
decode_shade_rows_q, shade_table_kind), the full graph shading from
them, and their per-instance side table after a dynamic commit.

The quantized table is forced on small scenes in both packages, as the
reference's tests/test_shade_q.py forces it: the exact table dropped,
the quantized one attached."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridrenderer_tpu.core.camera import OrbitCamera as RefCamera
from hybridrenderer_tpu.scene import dynamic as ref_dynamic
from hybridrenderer_tpu.scene import schema as ref_schema
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.ops import trace
from hybridrenderer_tpu_torch.ops.image import tri_boundary_mask
from hybridrenderer_tpu_torch.runtime.output import to_u8
from hybridrenderer_tpu_torch.runtime.renderer import Renderer
from hybridrenderer_tpu_torch.scene import dynamic, schema
from hybridrenderer_tpu_torch.scene import scene as port_scenes
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

from .test_torch_full_graph import FULL, REF_FULL
from .test_torch_full_graph_raw import (NO_SVGF, REF_NO_SVGF, _edge_mask,
                                       _off_edge, _reference_secondary_hits)
from .test_torch_slice import (CORNELL_CAM, _edge_tri_ids, _settings,
                               reference_renderer)
from .torch_parity import (clear_reference_knobs, flatten, one_torch_thread,
                           record_secondary_hits)

SCENES = {"cornell": ref_scenes.cornell_scene,
          "stress24_textured": lambda: ref_scenes.stress_scene(
              num_objects=24, textured=True, tex_size=16)}


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    clear_reference_knobs(monkeypatch)


def _with_q_table(data):
    """tests/test_shade_q.py::_with_q_table: the reference's scene as a
    large one would be built, on a small scene."""
    q = ref_schema.build_shade_rows_q(data.vertices, data.instances,
                                      data.triangles)
    return dataclasses.replace(
        data, shade_rows=None, shade_rows_q=q,
        inst_shade=ref_schema.build_inst_shade(data.instances,
                                               data.materials))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_quantized_table_and_decode_equal_reference(name):
    """The port's quantized table, side table and decoded rows equal the
    reference's bit for bit; scene_from_numpy carries the reference's
    forced table over and the tracer shades from its decode."""
    ref_data = SCENES[name]().build()
    with one_torch_thread():
        data = scene_from_numpy(flatten(ref_data), "cpu")
        assert data.shade_rows_q is None and data.inst_shade is None
        q = schema.build_shade_rows_q(data.vertices, data.instances,
                                      data.triangles)
        side = schema.build_inst_shade(data.instances, data.materials)
        inst = data.triangles.instance.long()
        dec = schema.decode_shade_rows_q(q, side[inst])
    ref_q = _with_q_table(ref_data)
    np.testing.assert_array_equal(q.numpy(),
                                  np.asarray(ref_q.shade_rows_q).astype(
                                      np.int32))
    np.testing.assert_array_equal(side.numpy().view(np.int32),
                                  np.asarray(ref_q.inst_shade).view(np.int32))
    ref_dec = np.asarray(ref_schema.decode_shade_rows_q(
        ref_q.shade_rows_q, ref_q.inst_shade[ref_data.triangles.instance]))
    np.testing.assert_array_equal(dec.numpy().view(np.int32),
                                  ref_dec.view(np.int32))
    with one_torch_thread():
        forced = scene_from_numpy(flatten(ref_q), "cpu")
        rows = trace._shade_rows(forced)
    assert torch.equal(forced.shade_rows_q, q)
    np.testing.assert_array_equal(rows.numpy().view(np.int32),
                                  ref_dec.view(np.int32))


def test_full_graph_frame_from_quantized_rows_matches_reference():
    """The full graph with SVGF off at 48x48 on cornell, shading its
    reflection and GI hits from the forced quantized table in both
    packages, the reference jitted: 2 u8 off edges, p99 1 (the gate of
    tests/test_torch_full_graph_raw.py; pixels whose secondary ray hits
    another triangle are edges there too)."""
    size = 48
    ref_data = _with_q_table(ref_scenes.cornell_scene().build())
    ref = reference_renderer(ref_data, size, REF_FULL & REF_NO_SVGF)
    with one_torch_thread():
        port = Renderer.for_scene(
            _settings(size).replace(flags=FULL & NO_SVGF),
            scene_from_numpy(flatten(ref_data), "cpu"))
        assert port.scene.shade_rows_q is not None
        port_hits = record_secondary_hits(port)
        ref_cam = RefCamera(width=size, height=size, **CORNELL_CAM)
        cam = OrbitCamera(width=size, height=size, **CORNELL_CAM)
        with _reference_secondary_hits(ref, ref_data) as ref_hits:
            ref_state = ref_cam.step()
            ref_img = to_u8(np.asarray(ref.render(ref_state)))
            img = to_u8(port.render_np(cam.step()))
            mask = _edge_mask(tri_boundary_mask(
                _edge_tri_ids(ref_data, ref_state, size), dilate=1),
                port_hits(), ref_hits())
    assert ref_img.std() > 0.0
    off_max, p99 = _off_edge(img, ref_img, mask)
    assert off_max <= 2 and p99 <= 1.0, (off_max, p99)


def test_dynamic_commit_refreshes_instance_side_table():
    """A dynamic update of a scene on the quantized table rebuilds its
    side table as the reference's rebuilds inst_shade (bit for bit after
    a turned cube), and the refit tracer's rows take the new normal
    matrices while the quantized table stays."""
    ref_host = ref_scenes.cornell_scene()
    ref_data = _with_q_table(ref_host.build())
    host = port_scenes.cornell_scene()
    with one_torch_thread():
        data = scene_from_numpy(flatten(ref_data), "cpu")
        host.build("cpu")
        maps = dynamic.build_maps(host, "cpu")
        tf = np.stack([r[1] for r in host._built["rows"]]).astype(np.float32)
        c, s = np.cos(0.4), np.sin(0.4)
        turn = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0],
                         [0, 0, 0, 1]], np.float32)
        tf[maps.instance_entity.numpy() == 6] = turn
        new = dynamic.update_transforms(data, maps, torch.from_numpy(tf))
        tracer = trace.SceneTracer.build(data).refit(new)
    ref_new = ref_dynamic.update_transforms(
        ref_data, ref_dynamic.build_maps(ref_host), jnp.asarray(tf))
    np.testing.assert_array_equal(
        new.inst_shade.numpy().view(np.int32),
        np.asarray(ref_new.inst_shade).view(np.int32))
    assert torch.equal(new.shade_rows_q, data.shade_rows_q)
    ref_dec = np.asarray(ref_schema.decode_shade_rows_q(
        ref_new.shade_rows_q,
        ref_new.inst_shade[ref_new.triangles.instance]))
    np.testing.assert_array_equal(tracer.shade_rows.numpy().view(np.int32),
                                  ref_dec.view(np.int32))


@pytest.mark.parametrize("tris,instances", [
    (schema.SHADE_ROWS_MAX, 10), (schema.SHADE_ROWS_MAX + 1, 10),
    (schema.SHADE_Q_ROWS_MAX, 65536), (schema.SHADE_Q_ROWS_MAX, 65537),
    (schema.SHADE_Q_ROWS_MAX + 1, 10), (284066, 1019)])
def test_table_choice_follows_reference(tris, instances):
    """shade_table_kind against the reference's own build functions,
    evaluated on shapes only (jax.eval_shape builds no big scene)."""
    f32 = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.float32)
    i32 = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.int32)
    exact = jax.eval_shape(ref_schema.build_shade_rows, f32(tris, 84))
    verts = ref_schema.VertexArrays(position=f32(8, 3),
                                    world_position=f32(8, 3),
                                    normal=f32(8, 3), tangent=f32(8, 4),
                                    uv=f32(8, 2))
    ns = types.SimpleNamespace

    def quantized(verts, tf, mat, idx):
        return ref_schema.build_shade_rows_q(
            verts, ns(transform=tf, material=mat),
            ns(i0=idx, i1=idx, i2=idx, instance=idx))

    quant = None if exact is not None else jax.eval_shape(
        quantized, verts, f32(instances, 4, 4), i32(instances), i32(tris))
    ref_kind = "shade_rows" if exact is not None else \
        "shade_rows_q" if quant is not None else "attr_rows"
    assert schema.shade_table_kind(tris, instances) == ref_kind


def test_alpha_test_reads_exact_uv_over_quantized_rows():
    """In a cut-out scene on the quantized table the alpha test still
    reads the exact corner uv, as the reference's surface_alpha reads
    attr_rows: its (is-masked, alpha, cutoff) equal the reference's bit
    for bit at seeded hits, where the quantized rows' uv would not."""
    from hybridrenderer_tpu.core.config import RenderSettings as RefSettings
    from hybridrenderer_tpu.ops import trace as ref_trace

    host = ref_scenes.cutout_scene()
    for m in host.meshes:   # uv deltas that f16 does not hold exactly
        m.uvs = (m.uvs * 0.737 + 0.013).astype(np.float32)
    ref_data = _with_q_table(host.build())
    ref_tracer = ref_trace.SceneTracer.build(
        ref_data, RefSettings(trace_backend="jnp"))
    g = np.random.default_rng(11)
    R = 512
    tri = g.integers(0, int(ref_data.triangles.v0.shape[0]), R).astype(
        np.int32)
    u = g.uniform(0, 1, R).astype(np.float32)
    v = (g.uniform(0, 1, R) * (1 - u)).astype(np.float32)
    ref = [np.asarray(x) for x in ref_tracer.surface_alpha(
        ref_data, jnp.asarray(tri), jnp.asarray(u), jnp.asarray(v))]
    with one_torch_thread():
        data = scene_from_numpy(flatten(ref_data), "cpu")
        tracer = trace.SceneTracer.build(data)
        mine = [x.numpy() for x in tracer.surface_alpha(
            torch.from_numpy(tri), torch.from_numpy(u), torch.from_numpy(v))]
    assert tracer.alpha_uv is not None and ref[0].any()
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)
    # the quantized rows' uv move the alpha: the exact uv are needed
    tracer.alpha_uv = None
    with one_torch_thread():
        moved = tracer.surface_alpha(torch.from_numpy(tri),
                                     torch.from_numpy(u), torch.from_numpy(v))
    assert (moved[1].numpy() != ref[1]).any()
