"""Port vs reference: the texture stack and its bilinear sampler, the
textured material slots, normal maps, the equirect sky, and the stack a
scene carries (Scene.build, scene_from_numpy). Both packages get the
same seeded numpy inputs; the reference runs its jnp functions on the
CPU, both of its samplers: the 4-tap ``sample_bilinear`` and the
quad-texel ``sample_bilinear_quad`` over ``build_quads``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridrenderer_tpu.ops import shade as ref_shade
from hybridrenderer_tpu.ops import sky as ref_sky
from hybridrenderer_tpu.ops import texture as ref_texture
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu.scene.schema import TextureStack as RefStack
from hybridrenderer_tpu_torch.ops import shade, sky, texture
from hybridrenderer_tpu_torch.scene import scene as port_scenes
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy
from hybridrenderer_tpu_torch.scene.schema import TextureStack

from .torch_parity import clear_reference_knobs, flatten, one_torch_thread

N_PTS = 4096


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    clear_reference_knobs(monkeypatch)
    with one_torch_thread():
        yield


def _stack(seed=0):
    """Two textures of different sizes in one padded stack: 64x64 beside
    32 rows x 16 columns, the rest of its 64x64 slot garbage that a
    correct wrap never reads."""
    g = np.random.default_rng(seed)
    data = g.random((2, 64, 64, 4)).astype(np.float32)
    sizes = np.array([[64, 64], [32, 16]], np.int32)
    return data, sizes


def _queries(seed=1, n=N_PTS, ids=(-1, 0, 1)):
    """tex ids among ``ids`` and UVs in [-2.5, 3.5]: negative, above 1,
    and exactly on texel centres and edges."""
    g = np.random.default_rng(seed)
    uv = g.uniform(-2.5, 3.5, (n, 2)).astype(np.float32)
    uv[:64] = np.round(uv[:64] * 64.0) / 64.0
    uv[64:128] = (np.round(uv[64:128] * 16.0) + 0.5) / 16.0
    tid = g.choice(np.array(ids, np.int32), n)
    return tid, uv


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_stack(data, sizes, usage=(True, True, True, True)):
    return TextureStack(data=_t(data), sizes=_t(sizes), slot_usage=usage)


def _ref_stack(data, sizes, usage=(True, True, True, True)):
    return RefStack(data=jnp.asarray(data), sizes=jnp.asarray(sizes),
                    slot_usage=usage)


@pytest.mark.parametrize("sampler", ["bilinear", "quad"])
@pytest.mark.parametrize("jit", [False, True])
def test_sampler_matches_reference(sampler, jit):
    """The port's 4-tap sampler equals the reference's 4-tap and
    quad-texel samplers bit for bit, eagerly: mixed texture sizes in one
    padded stack, UVs outside [0, 1], id -1. Jitted, XLA contracts the
    lerps into multiply-adds, which moves ~18% of the samples by one
    ulp: held to 1e-6 there."""
    data, sizes = _stack()
    tid, uv = _queries()
    default = np.array([0.25, 0.5, 0.75, 1.0], np.float32)
    if sampler == "bilinear":
        fn = lambda u, t: ref_texture.sample_bilinear(
            jnp.asarray(data), jnp.asarray(sizes), t, u, jnp.asarray(default))
    else:
        quads = ref_texture.build_quads(data, sizes)
        fn = lambda u, t: ref_texture.sample_bilinear_quad(
            quads, jnp.asarray(sizes), t, u, jnp.asarray(default))
    want = np.asarray((jax.jit(fn) if jit else fn)(jnp.asarray(uv),
                                                   jnp.asarray(tid)))
    got = texture.sample_bilinear(_t(data), _t(sizes), _t(tid), _t(uv),
                                  tuple(default)).numpy()
    if jit:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    assert (got[tid < 0] == default).all()


def test_sampler_wraps_by_true_size():
    """REPEAT wrap by a padded texture's own size: the 32x16 texture
    sampled at a texel centre shifted by whole periods, negative
    included, returns that texel; the padding is never read."""
    data, sizes = _stack()
    data[1, 32:] = np.nan
    data[1, :, 16:] = np.nan
    ys, xs = np.meshgrid(np.arange(32), np.arange(16), indexing="ij")
    shift = np.random.default_rng(2).integers(-3, 4, (32, 16, 2))
    uv = np.stack([(xs + 0.5) / 16.0 + shift[..., 0],
                   (ys + 0.5) / 32.0 + shift[..., 1]], -1).astype(np.float32)
    got = texture.sample_stack(_port_stack(data, sizes),
                               torch.ones((32, 16), dtype=torch.int32),
                               _t(uv), (0.0, 0.0, 0.0, 0.0)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, data[1, :32, :16], atol=2e-6)


def _material_rows(g, n, slot_ids):
    """(n, 16) packed material rows with texture ids drawn from
    ``slot_ids`` for the colour, emission, roughness and normal slots."""
    rows = g.uniform(0.0, 1.0, (n, 16)).astype(np.float32)
    rows[:, 9] = 0.0
    for col in (10, 11, 12, 13):
        rows[:, col] = g.choice(np.array(slot_ids, np.float32), n)
    rows[:, 14] = 0.0
    return rows


def _point_fields(mp):
    return {f.name: np.asarray(getattr(mp, f.name))
            for f in dataclasses.fields(mp)}


def test_material_point_all_slots():
    """Colour / opacity, emission and roughness / metallic (texel
    channels 1 and 2) modulated by their textures, ids -1, 0 and 1."""
    data, sizes = _stack()
    g = np.random.default_rng(3)
    rows = _material_rows(g, N_PTS, (-1, 0, 1))
    _, uv = _queries(4)
    want = _point_fields(ref_shade.material_point_from_row(
        jnp.asarray(rows), jnp.asarray(uv), _ref_stack(data, sizes)))
    got = _point_fields(shade.material_point_from_row(
        _t(rows), _t(uv), _port_stack(data, sizes)))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_unused_slot_equals_id_minus_one():
    """A slot no material binds is not sampled, and gives the bits that
    sampling it with id -1 gives (a multiply by the default 1.0)."""
    data, sizes = _stack()
    g = np.random.default_rng(5)
    rows = _material_rows(g, N_PTS, (0, 1))
    rows[:, 11:13] = -1.0
    _, uv = _queries(6)
    gated = _point_fields(shade.material_point_from_row(
        _t(rows), _t(uv), _port_stack(data, sizes,
                                      (True, False, False, False))))
    sampled = _point_fields(shade.material_point_from_row(
        _t(rows), _t(uv), _port_stack(data, sizes)))
    for k, v in sampled.items():
        np.testing.assert_array_equal(gated[k], v, err_msg=k)


def test_normal_map_matches_reference():
    """The TBN normal map: normal texture ids -1, 0 and 1, bitangent
    signs -1 and 1, w = 0 (taken as 1) and |w| below 0.001, and tangents
    shorter than 0.001 (the normal unmapped)."""
    data, sizes = _stack()
    g = np.random.default_rng(7)
    n = N_PTS
    normal = g.normal(size=(n, 3)).astype(np.float32)
    tangent = np.concatenate([g.normal(size=(n, 3)),
                              g.choice([-1.0, 1.0, 0.0, 5e-4], (n, 1))],
                             -1).astype(np.float32)
    tangent[:256, :3] *= 1e-4
    tangent[256:300, :3] = 0.0
    nrm_id = g.choice(np.array([-1, 0, 1], np.int32), n)
    _, uv = _queries(8)
    mats = ref_scenes.cube_scene().build().materials
    want = np.asarray(ref_shade.apply_normal_map(
        mats, jnp.zeros(n, jnp.int32), jnp.asarray(normal),
        jnp.asarray(tangent), jnp.asarray(uv), _ref_stack(data, sizes),
        nrm_tex_id=jnp.asarray(nrm_id)))
    got = shade.apply_normal_map(
        None, None, _t(normal), _t(tangent), _t(uv),
        _port_stack(data, sizes), nrm_tex_id=_t(nrm_id)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    plain = np.abs(tangent[:, :3]).max(-1) == 0.0
    np.testing.assert_allclose(
        got[plain], normal[plain] / np.linalg.norm(normal[plain], axis=-1,
                                                   keepdims=True),
        atol=1e-6)


@pytest.mark.parametrize("sky_texture", [1, -1])
def test_environment_with_sky_texture(sky_texture):
    """The equirect sky (texture 1, the 32x16 one) on directions over the
    sphere, the poles and the seam included, and the procedural sky where
    the id is -1. XLA's and PyTorch's atan2 and asin may round an ulp
    apart: 1e-5. Random directions keep |y| < 0.99, where asin's
    condition keeps an ulp of y below 1e-5 of a texel's value (at
    |y| -> 1 an ulp of y moves v by ~1e-4)."""
    data, sizes = _stack()
    g = np.random.default_rng(9)
    d = g.normal(size=(N_PTS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = d[np.abs(d[:, 1]) < 0.99]
    d[:8] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1],
             [0, 0, -1], [-1, 0, 1e-7], [-1, 0, -1e-7]]
    want = np.asarray(ref_sky.sample_environment(
        jnp.asarray(d), jnp.int32(sky_texture), _ref_stack(data, sizes),
        True, True))
    got = sky.sample_environment(_t(d), sky_texture,
                                 _port_stack(data, sizes), True, True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    uv_want = np.asarray(ref_sky.sample_equirectangular_uv(jnp.asarray(d)))
    uv_got = sky.sample_equirectangular_uv(_t(d)).numpy()
    np.testing.assert_allclose(uv_got, uv_want, rtol=0, atol=1e-6)


SCENES = {
    "stress_textured": (
        lambda: ref_scenes.stress_scene(num_objects=12, textured=True,
                                        tex_size=32),
        lambda: port_scenes.stress_scene(num_objects=12, textured=True,
                                         tex_size=32)),
    "cutout": (ref_scenes.cutout_scene, port_scenes.cutout_scene),
    "cube": (ref_scenes.cube_scene, port_scenes.cube_scene),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_stack_matches_reference(name):
    """Scene.build and scene_from_numpy give the reference's texels,
    sizes, slot usage and alpha / sky flags."""
    ref_fn, port_fn = SCENES[name]
    ref = ref_fn().build()
    for data in (port_fn().build("cpu"),
                 scene_from_numpy(flatten(ref), "cpu")):
        np.testing.assert_array_equal(data.textures.data.numpy(),
                                      np.asarray(ref.textures.data))
        np.testing.assert_array_equal(data.textures.sizes.numpy(),
                                      np.asarray(ref.textures.sizes))
        assert data.textures.slot_usage == ref.textures.slot_usage
        assert data.has_alpha_test == ref.has_alpha_test
        assert data.has_sky_texture == ref.has_sky_texture


def test_scene_from_numpy_refuses_u8_and_quad_only():
    tree = flatten(ref_scenes.cutout_scene().build())
    tex = tree["textures"]
    with pytest.raises(ValueError, match="float32"):
        scene_from_numpy(dict(tree, textures=dict(
            tex, data=(tex["data"] * 255).astype(np.uint8))), "cpu")
    with pytest.raises(ValueError, match="quad-only"):
        scene_from_numpy(dict(tree, textures=dict(tex, data=None)), "cpu")


def test_skybox_pass_and_sky_light_match_reference():
    """A scene with an equirect sky texture (the 32x16 one): the skybox
    demo pass's fullscreen sky against the reference's, to the sky
    test's 1e-5, and the sky as the light table's environment light."""
    import types

    from hybridrenderer_tpu.core.camera import OrbitCamera as RefCamera
    from hybridrenderer_tpu.core.config import RenderSettings as RefSettings
    from hybridrenderer_tpu.core.types import RenderFlags as RefFlags
    from hybridrenderer_tpu.graph import passes as ref_passes
    from hybridrenderer_tpu_torch.core.camera import OrbitCamera
    from hybridrenderer_tpu_torch.core.config import RenderSettings
    from hybridrenderer_tpu_torch.core.types import RenderFlags
    from hybridrenderer_tpu_torch.graph import passes
    from hybridrenderer_tpu_torch.graph.params import RS

    data, sizes = _stack()
    ref_sc, sc = ref_scenes.cube_scene(), port_scenes.cube_scene()
    ref_sc.textures = _ref_stack(data, sizes)
    sc.textures = _port_stack(data, sizes)
    ref_sc.sky_texture = sc.sky_texture = 1
    ref_data, port_data = ref_sc.build(), sc.build("cpu")
    assert port_data.has_sky_texture and ref_data.has_sky_texture
    for f in ("instance", "cdf_start", "cdf_count", "environment", "cdf"):
        np.testing.assert_array_equal(getattr(port_data.lights, f).numpy(),
                                      np.asarray(getattr(ref_data.lights, f)),
                                      err_msg=f)
    W, H = 48, 32
    cam_kw = dict(distance=6.0, pitch=0.5, yaw=0.3)
    ref_fn = ref_passes.make_skybox_pass(RefSettings(
        width=W, height=H, flags=RefFlags.IBL))[0]
    want = np.asarray(ref_fn({}, types.SimpleNamespace(
        cam=RefCamera(width=W, height=H, **cam_kw).step(),
        scene=ref_data))[RS.FINAL_COLOR])
    fn, reads, writes, _ = passes.make_skybox_pass(RenderSettings(
        width=W, height=H, flags=RenderFlags.IBL))
    assert reads == () and writes == (RS.FINAL_COLOR,)
    got = fn({}, types.SimpleNamespace(
        cam=OrbitCamera(width=W, height=H, **cam_kw).step().to(
            torch.device("cpu")), scene=port_data))[RS.FINAL_COLOR]
    assert got.shape == (H, W, 3) and want.std() > 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _all_slots_cube():
    """The cube scene with the cube's material binding all four slots
    (colour and roughness-metallic texture 0, emission and normal map
    texture 1); the floor, which the near plane clips, stays untextured
    (clipped barycentrics are ill-conditioned;
    tests/test_torch_textured_frames.py)."""
    data, sizes = _stack()
    sc = ref_scenes.cube_scene()
    m = sc.materials[1]
    m.colour_texture, m.roughness_texture = 0, 0
    m.emission_texture, m.normal_texture = 1, 1
    m.emission = (0.5, 0.4, 0.3)
    sc.textures = _ref_stack(data, sizes)
    return sc.build()


def test_all_slots_forward_frame_matches_reference():
    """The G-buffer's four slots and normal-mapped normals in a forward
    frame (LIGHT | IBL, 48x48) against the reference, to 2 u8 off
    triangle edges, p99 1."""
    from hybridrenderer_tpu.core.camera import OrbitCamera as RefCamera
    from hybridrenderer_tpu.core.config import RenderSettings as RefSettings
    from hybridrenderer_tpu.core.types import RenderFlags as RefFlags
    from hybridrenderer_tpu.core.types import RenderPathType as RefPath
    from hybridrenderer_tpu.runtime.renderer import Renderer as RefRenderer
    from hybridrenderer_tpu_torch.core.camera import OrbitCamera
    from hybridrenderer_tpu_torch.core.config import RenderSettings
    from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType
    from hybridrenderer_tpu_torch.runtime.output import to_u8
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    from .test_torch_slice import CUBE_CAM, _edge_tri_ids
    from .torch_parity import off_edge_errors

    ref_data = _all_slots_cube()
    size = 48
    ref = RefRenderer.for_scene(RefSettings(
        width=size, height=size, path=RefPath.FORWARD,
        flags=RefFlags.LIGHT | RefFlags.IBL, raster_backend="jnp"), ref_data)
    state = RefCamera(width=size, height=size, **CUBE_CAM).step()
    want = to_u8(np.asarray(ref.render(state)))
    data = scene_from_numpy(flatten(ref_data), "cpu")
    assert data.textures.slot_usage == (True, True, True, True)
    r = Renderer.for_scene(RenderSettings(
        width=size, height=size, path=RenderPathType.FORWARD,
        flags=RenderFlags.LIGHT | RenderFlags.IBL), data)
    img = to_u8(r.render_np(OrbitCamera(width=size, height=size,
                                        **CUBE_CAM).step()))
    off_max, p99 = off_edge_errors(img, want,
                                   _edge_tri_ids(ref_data, state, size))
    assert off_max <= 2 and p99 <= 1.0, (off_max, p99)


def test_radiance_hits_with_all_slots_match_reference():
    """Radiance rays at the all-slots cube from around it: hit shading
    with the four slots and the normal map (IBL, and the emissive cube's
    light sampled by NEE), against the reference's trace_radiance on its
    jnp traversal, to tests/test_torch_radiance.py's tolerances. The sun
    stays off: a hit whose geometric normal faces away from it traces no
    occlusion ray, which the port reports as 0.0 (the reference's
    documented value, and its TPU kernels') and the reference's jnp
    traversal as 1.0, and a normal map can leave such a hit a nonzero
    sun term (ROADMAP queue 3)."""
    import types

    from hybridrenderer_tpu.core.config import RenderSettings as RefSettings
    from hybridrenderer_tpu.core.types import RenderFlags as RefFlags
    from hybridrenderer_tpu.graph.params import FrameParams as RefParams
    from hybridrenderer_tpu.ops import trace as ref_trace
    from hybridrenderer_tpu_torch.core.config import RenderSettings
    from hybridrenderer_tpu_torch.core.types import RenderFlags
    from hybridrenderer_tpu_torch.graph.params import FrameParams
    from hybridrenderer_tpu_torch.ops.trace import SceneTracer

    ref_data = _all_slots_cube()
    data = scene_from_numpy(flatten(ref_data), "cpu")
    g = np.random.default_rng(12)
    o = g.normal(size=(32, 32, 3)).astype(np.float32)
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True) + [0, 0.75, 0]
    target = g.uniform(-0.6, 0.6, (32, 32, 3)) + [0, 0.75, 0]
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = o.astype(np.float32)
    flags = RenderFlags.IBL
    ref_ctx = types.SimpleNamespace(
        settings=RefSettings(flags=RefFlags(int(flags))),
        params=RefParams.create(ref_data, frame_index=2))
    ctx = types.SimpleNamespace(settings=RenderSettings(flags=flags),
                                params=FrameParams.create(data, frame_index=2))
    want_rgb, want_dist = (np.asarray(x) for x in
                           ref_trace.SceneTracer.build(ref_data)
                           .trace_radiance(ref_data, jnp.asarray(o),
                                           jnp.asarray(d), ref_ctx, 0))
    rgb, dist = SceneTracer.build(data).trace_radiance(
        data, torch.from_numpy(o), torch.from_numpy(d), ctx, 0)
    assert (want_dist > 0).mean() > 0.5
    np.testing.assert_allclose(dist.numpy(), want_dist, rtol=1e-5)
    np.testing.assert_allclose(rgb.numpy(), want_rgb, rtol=1e-4, atol=1e-5)
