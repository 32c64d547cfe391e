"""Radiance-query cases for the staged hit shading (ops/shade_cuda.py),
shared by its CPU tests (tests/test_torch_shade_stages.py) and its card
tests (tests/test_torch_cuda.py): a scene, the tracer's settings, the
frame's flags, an image of rays with some inactive and some aimed at the
sky, and the row window. No JAX: the card tests run without it.

``unsplit_trace_radiance`` is ``SceneTracer.trace_radiance`` as it was
before the shading was split in two stages, kept as the oracle the
stages are held to bit for bit."""
import dataclasses
import types

import numpy as np
import torch

from hybridrenderer_tpu_torch.core import maths
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.core.types import RenderFlags
from hybridrenderer_tpu_torch.graph.params import FrameParams
from hybridrenderer_tpu_torch.ops import sampling, shade, sky
from hybridrenderer_tpu_torch.ops.trace import SceneTracer
from hybridrenderer_tpu_torch.scene import schema
from hybridrenderer_tpu_torch.scene import scene as scenes
from hybridrenderer_tpu_torch.scene.schema import TextureStack

FULL = RenderFlags.LIGHT | RenderFlags.IBL
H, W = 20, 24


def _stack(seed=0):
    """Two textures in one padded stack: 64x64 beside 32 rows x 16
    columns (tests/test_torch_textures.py's)."""
    g = np.random.default_rng(seed)
    data = g.random((2, 64, 64, 4)).astype(np.float32)
    sizes = np.array([[64, 64], [32, 16]], np.int32)
    return TextureStack(data=torch.from_numpy(data),
                        sizes=torch.from_numpy(sizes))


def _all_slots_cube():
    """The cube binding all four slots (colour and roughness-metallic
    texture 0, emission and normal map texture 1), emissive, so NEE
    samples it."""
    sc = scenes.cube_scene()
    m = sc.materials[1]
    m.colour_texture, m.roughness_texture = 0, 0
    m.emission_texture, m.normal_texture = 1, 1
    m.emission = (0.5, 0.4, 0.3)
    sc.textures = _stack()
    return sc


def _sky_cube():
    """The cube under an equirect sky texture (texture 1), which the
    light table also lists as an environment light."""
    sc = scenes.cube_scene()
    sc.textures = _stack(3)
    sc.sky_texture = 1
    return sc


def _quantized(data):
    """``data`` shading from the quantized rows, as a scene above 98,304
    triangles does (tests/test_torch_shade_q.py forces it alike)."""
    return dataclasses.replace(
        data, shade_rows_q=schema.build_shade_rows_q(
            data.vertices, data.instances, data.triangles),
        inst_shade=schema.build_inst_shade(data.instances, data.materials))


# name → (host scene, quantized rows, tracer settings, flags, row0, rays
# around (centre, radius), share of rays aimed at the sky)
CASES = {
    "quantized_stress": (lambda: scenes.stress_scene(num_objects=12, seed=3),
                         True, {}, FULL, 0, ((0, 1, 0), 14.0), 0.15),
    "all_slots_cube": (_all_slots_cube, False, {}, FULL, 0,
                       ((0, 0.75, 0), 4.0), 0.1),
    "cornell_nee_row0": (scenes.cornell_scene, False, {}, FULL, 7,
                         ((0, 2.5, 0), 2.0), 0.0),
    "sky_texture": (_sky_cube, False, {}, FULL, 0, ((0, 0.75, 0), 4.0),
                    0.3),
    "ibl_off": (scenes.cornell_scene, False, {}, RenderFlags.LIGHT, 0,
                ((0, 2.5, 0), 2.0), 0.0),
    "light_off": (_all_slots_cube, False, {}, RenderFlags.IBL, 0,
                  ((0, 0.75, 0), 4.0), 0.2),
    "tile_order": (scenes.cornell_scene, False,
                   dict(trace_backend="pallas-wide", wide_kernel="compressed"),
                   FULL, 3, ((0, 2.5, 0), 2.0), 0.0),
    "cutout": (scenes.cutout_scene, False, {}, FULL, 0, ((0, 1.6, 0), 6.0),
               0.1),
}


def rays(centre, radius, sky_share, seed=5):
    """(origin (H, W, 3), direction (H, W, 3), active (H, W)): origins on
    a sphere about ``centre`` aimed at points near it (inside it, where
    the radius is that of a box the rays start in), ``sky_share`` of
    them upward, a tenth inactive."""
    g = np.random.default_rng(seed)
    c = np.asarray(centre, np.float32)
    o = g.normal(size=(H, W, 3))
    o = radius * o / np.linalg.norm(o, axis=-1, keepdims=True) + c
    target = g.uniform(-0.8, 0.8, (H, W, 3)) * min(radius, 1.5) + c
    d = target - o
    up = g.random((H, W)) < sky_share
    d[up] = g.normal(size=(int(up.sum()), 3)) * 0.3 + [0.0, 1.0, 0.0]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    active = g.random((H, W)) >= 0.1
    return (torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)),
            torch.from_numpy(active))


def build(name, device):
    """(tracer, scene, ctx, origin, direction, active, row0) of a case on
    ``device``."""
    host_fn, quantized, kw, flags, row0, (centre, radius), sky_share = \
        CASES[name]
    data = host_fn().build(device)
    if quantized:
        data = _quantized(data)
    tracer = SceneTracer.build(data, RenderSettings(**kw))
    ctx = types.SimpleNamespace(settings=RenderSettings(flags=flags),
                                params=FrameParams.create(data,
                                                          frame_index=5))
    o, d, a = (x.to(device) for x in rays(centre, radius, sky_share))
    return tracer, data, ctx, o, d, a, row0


def unsplit_trace_radiance(tracer, scene, origin, direction, ctx,
                           active=None, row0=0):
    """``SceneTracer.trace_radiance`` with its hit shading in one piece
    (``_shade_hit``), as before the staged shading."""
    h = tracer.radiance_hits(origin, direction, active)
    lead, o, d, t, tri, u, v, hit = h[:8]
    fwd, ray_idx = h.fwd, h.fwd
    if row0:
        if fwd is None:
            fwd = torch.arange(o.shape[0], dtype=torch.int64,
                               device=o.device)
        ray_idx = fwd + row0 * lead[1]
    rgb_hit = _shade_hit(tracer, scene, o, d, t, tri, u, v, ctx, hit,
                         ray_idx, h.width)
    rgb_miss = sky.sample_environment(
        d, scene.sky_texture, scene.textures,
        bool(ctx.settings.flags & RenderFlags.IBL),
        has_sky=scene.has_sky_texture)
    rgb = torch.where(hit.unsqueeze(-1), rgb_hit, rgb_miss)
    dist = torch.where(hit, t, torch.full_like(t, -1.0))
    if h.pos is not None:
        rgb, dist = rgb[h.pos], dist[h.pos]
    return rgb.reshape(*lead, 3), dist.reshape(lead)


def _shade_hit(self, sc, o, d, t, tri, u, v, ctx, active, ray_idx=None,
               width=0):
    params, flags = ctx.params, ctx.settings.flags
    R = o.shape[0]
    dev = o.device
    safe = torch.clamp(tri, 0, self.shade_rows.shape[0] - 1).long()
    b0 = (1.0 - u - v).unsqueeze(-1)
    b1 = u.unsqueeze(-1)
    b2 = v.unsqueeze(-1)
    world_pos = o + d * t.unsqueeze(-1)

    row = self.shade_rows[safe]
    lerp = row[:, 0:9] * b0 + row[:, 9:18] * b1 + row[:, 18:27] * b2
    ln = lerp[:, 0:3]
    lt = lerp[:, 3:7]
    uv = lerp[:, 7:9]
    nmat = row[:, 27:36]
    mrow = row[:, 37:53]

    def to_world(x):
        return torch.stack([maths.dot(nmat[:, 3 * i:3 * i + 3], x)
                            for i in range(3)], dim=-1)

    geo_n = maths.normalize(to_world(ln))
    flip = maths.dot(geo_n, d, keepdim=True) > 0.0
    geo_n = torch.where(flip, -geo_n, geo_n)
    mp = shade.material_point_from_row(mrow, uv, sc.textures)
    if shade.uses_normal_map(sc.textures):
        wt = torch.cat([maths.normalize(to_world(lt[:, :3])),
                        lt[:, 3:4]], dim=-1)
        n = shade.apply_normal_map(sc.materials, row[:, 36], geo_n, wt,
                                   uv, sc.textures,
                                   nrm_tex_id=mrow[:, 13].to(torch.int32))
    else:
        n = maths.normalize(geo_n)

    view = -d
    light_on = bool(flags & RenderFlags.LIGHT)
    sun_dir = maths.normalize(-params.sun_direction).expand(R, 3)
    sun_int = params.sun_color * params.sun_intensity if light_on \
        else torch.zeros(3, device=dev)
    shadow_origin = sampling.offset_ray(world_pos, geo_n)
    sun_brdf = shade.eval_pbr(mp.colour, 1.5, mp.roughness, mp.metallic,
                              n, view, sun_dir) * sun_int
    sun_act = None
    if light_on:
        sun_act = (maths.dot(geo_n, sun_dir) > 0.0) & active

    nee_act = None
    if sc.lights.count > 0:
        if ray_idx is None:
            ray_idx = torch.arange(R, dtype=torch.int64, device=dev)
        seed = sampling.init_random_seed(ray_idx, params.frame_index)
        ldir, sampled_inst, _ = sampling.sample_lights(sc, world_pos, seed)
        has = (maths.length(ldir) > 0.001) & (maths.dot(geo_n, ldir) > 0.0)
        inst_emission = sc.materials.emission[
            sc.instances.material.long()] * 5.0
        l_rad = inst_emission[torch.clamp(sampled_inst, min=0).long()]
        nee = shade.eval_pbr(mp.colour, 1.5, mp.roughness, mp.metallic,
                             n, view, ldir) * l_rad
        nee_act = has & active

    sun_shadow = torch.zeros((R,), device=dev)
    lshadow = None
    if sun_act is not None and nee_act is not None:
        both = self.occluded(torch.cat([shadow_origin, shadow_origin]),
                             torch.cat([sun_dir, ldir]), 1000.0,
                             torch.cat([sun_act, nee_act]), width)
        sun_shadow, lshadow = both[:R], both[R:]
    elif sun_act is not None:
        sun_shadow = self.occluded(shadow_origin, sun_dir, 1000.0, sun_act,
                                   width)
    elif nee_act is not None:
        lshadow = self.occluded(shadow_origin, ldir, 1000.0, nee_act, width)
    direct = sun_brdf * sun_shadow.unsqueeze(-1)
    if nee_act is not None:
        ok = (has & (lshadow > 0.5) & (sampled_inst >= 0)).unsqueeze(-1)
        direct = direct + torch.where(ok, nee, torch.zeros_like(nee))

    ambient = torch.zeros_like(direct)
    if flags & RenderFlags.IBL:
        r = maths.reflect(d, n)
        env_spec = sky.sample_environment(r, sc.sky_texture, sc.textures,
                                          True, sc.has_sky_texture)
        env_diff = sky.sample_environment(n, sc.sky_texture, sc.textures,
                                          True, sc.has_sky_texture)
        metal = mp.metallic.unsqueeze(-1)
        f0 = maths.mix(torch.full_like(mp.colour, 0.04), mp.colour, metal)
        f = shade.fresnel_schlick(f0, n, view)
        kd = (1.0 - f) * (1.0 - metal)
        amb_str = torch.clamp(params.ambient_strength, min=0.2)
        ambient = (kd * env_diff * mp.colour + f * env_spec) * amb_str
    return direct + ambient + mp.emission
