"""Hit shading of radiance rays (closesthit.rchit with miss.rmiss) in two
stages around the hit's occlusion query, each a CUDA kernel with its
plain PyTorch version:

* ``shade_hit_prepare`` (kernel ``hr_shade_hit``): one ray's hit shading
  up to its shadows. It reads the hit triangle's shade row in place,
  interpolates it, samples the material's textures and its normal map,
  evaluates the sun's BRDF, draws the NEE light sample and evaluates it,
  computes the IBL ambient term, and writes the occlusion rays (sun,
  then sampled light, stacked (K R, 3) as ``SceneTracer.occluded`` takes
  them) and the terms the finish adds (``HitShading.terms``);
* ``SceneTracer.occluded``: the any-hit query (K2, or the alpha rounds
  of a cut-out scene), unchanged;
* ``shade_hit_finish`` (kernel ``hr_shade_finish``): the shadowed sun
  and NEE terms plus ambient and emission at hits, the sky
  (``sky.sample_environment``) at misses, and the hit distance (-1 on a
  miss), written in pixel order where the rays were traced in another
  (``pos``).

Each stage's branches follow only what the scene's arrays and the frame's
flags show: the bound texture slots, the light count, the sky texture,
LIGHT and IBL. At rays that hit nothing both versions of the prepare
stage write zeros and no active occlusion ray.

CUDA tensors launch the kernels; CPU tensors take the plain versions,
which do the float operations of the reference's hit shading in its
order, as the kernels do (csrc/shade.cu).
"""
from __future__ import annotations

import ctypes
from typing import Any, NamedTuple

import torch

from .. import native
from ..core import maths
from ..core.types import RenderFlags
from . import sampling, shade, sky, texture

KERNEL_PREPARE = native.KERNELS["shade_hit"]
KERNEL_FINISH = native.KERNELS["shade_finish"]
SHADOW_TMAX = 1000.0    # the occlusion rays' reach
TERMS = 12              # sun BRDF, NEE, ambient, emission: rgb each


class HitShading(NamedTuple):
    """What the prepare stage hands on, for R rays."""
    occ_o: Any      # (K R, 3) f32 occlusion origins, or None (K = 0)
    occ_d: Any      # (K R, 3) f32 directions: the sun's, then the light's
    occ_act: Any    # (K R,) bool
    sun: bool       # whether rows 0 .. R-1 are the sun's rays
    nee: bool       # whether the last R rows are the sampled light's
    # (R, 12) f32: sun BRDF x intensity, the NEE term where a light was
    # sampled toward a facing hit (else 0), IBL ambient, emission
    terms: Any


def _flags(ctx):
    f = ctx.settings.flags
    return bool(f & RenderFlags.LIGHT), bool(f & RenderFlags.IBL)


def _sun(params, light_on, dev):
    """The sun's direction toward it and its rgb intensity (0 with LIGHT
    off), as (3,) tensors."""
    sun_dir = maths.normalize(-params.sun_direction)
    sun_int = params.sun_color * params.sun_intensity if light_on \
        else torch.zeros(3, device=dev)
    return sun_dir, sun_int


def _inst_emission(sc):
    """Each instance's emitted radiance as NEE takes it: (N, 3)."""
    return sc.materials.emission[sc.instances.material.long()] * 5.0


def shade_hit_prepare(shade_rows, sc, o, d, t, tri, u, v, hit, ctx,
                      ray_idx=None, idx_offset: int = 0) -> HitShading:
    """R traced rays with their closest hits (t, tri, u, v; ``hit`` the
    rays that hit a triangle) → HitShading. ``shade_rows`` is the
    tracer's (T, 53) hit-shading table; ``ray_idx`` (R,) int64, each
    ray's pixel index (None: its flat index), plus ``idx_offset`` seeds
    NEE.

    CUDA tensors launch ``hr_shade_hit``; CPU tensors take the plain
    version."""
    if o.device.type == "cpu":
        return shade_hit_prepare_plain(shade_rows, sc, o, d, t, tri, u, v,
                                       hit, ctx, ray_idx, idx_offset)
    if o.device.type != "cuda":
        raise ValueError(f"shade_hit_prepare: unsupported device {o.device}")
    dev = o.device
    R = o.shape[0]
    light_on, ibl = _flags(ctx)
    nee = sc.lights.count > 0
    K = int(light_on) + int(nee)
    for x, name, dt, shape in ((o, "o", torch.float32, (R, 3)),
                               (d, "d", torch.float32, (R, 3)),
                               (t, "t", torch.float32, (R,)),
                               (tri, "tri", torch.int32, (R,)),
                               (u, "u", torch.float32, (R,)),
                               (v, "v", torch.float32, (R,)),
                               (hit, "hit", torch.bool, (R,))):
        native.check(x, name, dt, shape, dev)
    if ray_idx is not None:
        native.check(ray_idx, "ray_idx", torch.int64, (R,), dev)
    scene, keep = _scene_args(shade_rows, sc, ctx, light_on, ibl)
    occ_o = torch.empty((K * R, 3), dtype=torch.float32, device=dev)
    occ_d = torch.empty((K * R, 3), dtype=torch.float32, device=dev)
    occ_act = torch.empty((K * R,), dtype=torch.bool, device=dev)
    terms = torch.empty((R, TERMS), dtype=torch.float32, device=dev)
    KERNEL_PREPARE.launch(
        "hr_shade_hit", ctypes.byref(scene), native.ptr(o), native.ptr(d),
        native.ptr(t), native.ptr(tri), native.ptr(u), native.ptr(v),
        native.ptr(hit), None if ray_idx is None else native.ptr(ray_idx),
        int(idx_offset), R, native.ptr(occ_o), native.ptr(occ_d),
        native.ptr(occ_act), native.ptr(terms))
    del keep
    if K == 0:
        occ_o = occ_d = occ_act = None
    return HitShading(occ_o, occ_d, occ_act, light_on, nee, terms)


def shade_hit_prepare_plain(shade_rows, sc, o, d, t, tri, u, v, hit, ctx,
                            ray_idx=None, idx_offset: int = 0) -> HitShading:
    """Plain PyTorch version of ``hr_shade_hit``: interpolate the hit's
    attributes, evaluate its material, the sun's BRDF and the NEE light
    sample (with the reference's facing gates on their occlusion rays),
    IBL ambient and emission."""
    KERNEL_PREPARE.note_plain(o)
    params = ctx.params
    light_on, ibl = _flags(ctx)
    R = o.shape[0]
    dev = o.device
    safe = torch.clamp(tri, 0, shade_rows.shape[0] - 1).long()
    b0 = (1.0 - u - v).unsqueeze(-1)
    b1 = u.unsqueeze(-1)
    b2 = v.unsqueeze(-1)
    world_pos = o + d * t.unsqueeze(-1)

    row = shade_rows[safe]
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
    # face the ray (closesthit.rchit:56)
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
    sun_dir, sun_int = _sun(params, light_on, dev)
    sun_dir = sun_dir.expand(R, 3)
    shadow_origin = sampling.offset_ray(world_pos, geo_n)
    sun_brdf = shade.eval_pbr(mp.colour, 1.5, mp.roughness, mp.metallic,
                              n, view, sun_dir) * sun_int
    # facing gates: a hit facing away from the sun or the sampled light
    # gets no light from it, so its occlusion ray is not traced
    origins, dirs, acts = [], [], []
    if light_on:
        origins.append(shadow_origin)
        dirs.append(sun_dir)
        acts.append((maths.dot(geo_n, sun_dir) > 0.0) & hit)

    nee = torch.zeros_like(sun_brdf)
    if sc.lights.count > 0:
        idx = torch.arange(R, dtype=torch.int64, device=dev) \
            if ray_idx is None else ray_idx
        if idx_offset:
            idx = idx + idx_offset
        seed = sampling.init_random_seed(idx, params.frame_index)
        ldir, sampled_inst, _ = sampling.sample_lights(sc, world_pos, seed)
        has = (maths.length(ldir) > 0.001) & (maths.dot(geo_n, ldir) > 0.0)
        l_rad = _inst_emission(sc)[torch.clamp(sampled_inst, min=0).long()]
        nee = shade.eval_pbr(mp.colour, 1.5, mp.roughness, mp.metallic,
                             n, view, ldir) * l_rad
        ok = (has & (sampled_inst >= 0)).unsqueeze(-1)
        nee = torch.where(ok, nee, torch.zeros_like(nee))
        origins.append(shadow_origin)
        dirs.append(ldir)
        acts.append(has & hit)

    # IBL ambient (closesthit.rchit:99-113)
    ambient = torch.zeros_like(sun_brdf)
    if ibl:
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

    # rays that hit nothing: every output 0
    h = hit.unsqueeze(-1)
    terms = torch.where(h, torch.cat([sun_brdf, nee, ambient, mp.emission],
                                     dim=-1), 0.0)
    if not acts:
        return HitShading(None, None, None, light_on, False, terms)
    occ_o = torch.where(h, shadow_origin, 0.0)
    return HitShading(torch.cat([occ_o] * len(acts)),
                      torch.cat([torch.where(h, x, 0.0) for x in dirs]),
                      torch.cat(acts), light_on, sc.lights.count > 0, terms)


def shade_hit_finish(sc, ctx, terms, sun_vis, l_vis, hit, t, d, pos=None):
    """The prepare stage's ``terms`` (R, 12) with the occlusion query's
    visibility of the sun (``sun_vis``, (R,), None: no sun rays) and of
    the sampled light (``l_vis``, None: no NEE), at the rays' hits
    (``hit``, ``t``; the sky toward ``d`` elsewhere) → (rgb (P, 3),
    distance (P,), -1 on a miss), P = R, or in pixel order where ``pos``
    (P,) int64 holds each pixel's traced position.

    CUDA tensors launch ``hr_shade_finish``; CPU tensors take the plain
    version."""
    if d.device.type == "cpu":
        return shade_hit_finish_plain(sc, ctx, terms, sun_vis, l_vis, hit,
                                      t, d, pos)
    if d.device.type != "cuda":
        raise ValueError(f"shade_hit_finish: unsupported device {d.device}")
    dev = d.device
    R = d.shape[0]
    native.check(terms, "terms", torch.float32, (R, TERMS), dev)
    native.check(hit, "hit", torch.bool, (R,), dev)
    native.check(t, "t", torch.float32, (R,), dev)
    native.check(d, "d", torch.float32, (R, 3), dev)
    for x, name in ((sun_vis, "sun_vis"), (l_vis, "l_vis")):
        if x is not None:
            native.check(x, name, torch.float32, (R,), dev)
    P = R
    if pos is not None:
        P = pos.shape[0]
        native.check(pos, "pos", torch.int64, (P,), dev)
    light_on, ibl = _flags(ctx)
    scene, keep = _scene_args(None, sc, ctx, light_on, ibl)
    rgb = torch.empty((P, 3), dtype=torch.float32, device=dev)
    dist = torch.empty((P,), dtype=torch.float32, device=dev)

    def opt(x):
        return None if x is None else native.ptr(x)

    KERNEL_FINISH.launch(
        "hr_shade_finish", ctypes.byref(scene), native.ptr(terms),
        opt(sun_vis), opt(l_vis), native.ptr(hit), native.ptr(t),
        native.ptr(d), opt(pos), P, native.ptr(rgb), native.ptr(dist))
    del keep
    return rgb, dist


def shade_hit_finish_plain(sc, ctx, terms, sun_vis, l_vis, hit, t, d,
                           pos=None):
    """Plain PyTorch version of ``hr_shade_finish``."""
    KERNEL_FINISH.note_plain(d)
    _, ibl = _flags(ctx)
    if sun_vis is None:
        sun_vis = torch.zeros_like(t)
    direct = terms[:, 0:3] * sun_vis.unsqueeze(-1)
    if l_vis is not None:
        nee = terms[:, 3:6]
        direct = direct + torch.where((l_vis > 0.5).unsqueeze(-1), nee,
                                      torch.zeros_like(nee))
    rgb_hit = direct + terms[:, 6:9] + terms[:, 9:12]
    rgb_miss = sky.sample_environment(d, sc.sky_texture, sc.textures, ibl,
                                      has_sky=sc.has_sky_texture)
    rgb = torch.where(hit.unsqueeze(-1), rgb_hit, rgb_miss)
    dist = torch.where(hit, t, torch.full_like(t, -1.0))
    if pos is not None:
        rgb, dist = rgb[pos], dist[pos]
    return rgb, dist


def shade_radiance(tracer, sc, o, d, t, tri, u, v, hit, ctx, ray_idx=None,
                   idx_offset: int = 0, width: int = 0, pos=None):
    """closesthit.rchit and miss.rmiss over R traced rays: the prepare
    stage, the occlusion query of its rays (``tracer.occluded``; ``width``
    as there), the finish → (rgb (P, 3), distance (P,)) as
    ``shade_hit_finish`` gives them."""
    prep = shade_hit_prepare(tracer.shade_rows, sc, o, d, t, tri, u, v, hit,
                             ctx, ray_idx, idx_offset)
    sun_vis = l_vis = None
    if prep.occ_o is not None:
        vis = tracer.occluded(prep.occ_o, prep.occ_d, SHADOW_TMAX,
                              prep.occ_act, width)
        R = o.shape[0]
        if prep.sun:
            sun_vis = vis[:R]
        if prep.nee:
            l_vis = vis[-R:]
    return shade_hit_finish(sc, ctx, prep.terms, sun_vis, l_vis, hit, t, d,
                            pos)


# --- the kernels' scene arguments -------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64


class Textures(ctypes.Structure):
    """csrc/surface.cuh's HrTextures, field for field."""
    _fields_ = [("data", _P), ("sizes", _P), ("h", _I), ("w", _I),
                ("slots", _I)]


def textures_arg(tex, slots: bool, sky: bool, keep: list) -> Textures:
    """``Textures`` of the TextureStack ``tex``: the slots any material
    binds where ``slots`` and the stack holds textures (a material's
    slots are sampled only there: shade.material_point_from_row), and the
    stack's data where a slot or the sky (``sky``) samples it. The
    tensors it points into are appended to ``keep``, to keep alive until
    the launch."""
    t = Textures()
    if slots and texture.has_textures(tex):
        t.slots = sum(1 << k for k, used in enumerate(tex.slot_usage)
                      if used)
    if t.slots or sky:
        data = native.aligned(tex.data.contiguous())  # float4 taps
        sizes = tex.sizes.to(torch.int32)
        keep += [data, sizes]
        t.data, t.sizes = native.ptr(data), native.ptr(sizes)
        t.h, t.w = (int(x) for x in tex.data.shape[1:3])
    return t


class ShadeScene(ctypes.Structure):
    """csrc/shade.cu's HrShadeScene, field for field."""
    _fields_ = [
        ("rows", _P), ("n_rows", _L), ("tex", Textures),
        ("sky_tex", _I), ("has_sky", _I), ("light_on", _I), ("ibl", _I),
        ("n_lights", _I), ("n_cdf", _I),
        ("light_inst", _P), ("light_cdf_start", _P), ("light_cdf_count", _P),
        ("light_env", _P), ("cdf", _P),
        ("inst_index_offset", _P), ("inst_emission", _P),
        ("v0", _P), ("v1", _P), ("v2", _P),
        ("uniforms", _P), ("frame_index", _P),
    ]


def _scene_args(shade_rows, sc, ctx, light_on, ibl):
    """(ShadeScene, the tensors it points into, to keep alive until the
    launch). ``shade_rows`` None: the finish's arguments (sky and flags
    only)."""
    dev = sc.device
    params = ctx.params
    keep = []

    def p(x, dtype=torch.float32):
        if x.dtype != dtype or x.device != dev:
            raise ValueError(f"shade kernels: a {x.dtype} array on "
                             f"{x.device}, expected {dtype} on {dev}")
        x = x.contiguous()
        keep.append(x)
        return native.ptr(x)

    s = ShadeScene()
    s.sky_tex, s.has_sky = int(sc.sky_texture), int(bool(sc.has_sky_texture))
    s.light_on, s.ibl = int(light_on), int(ibl)
    # the sky is sampled where IBL is on
    s.tex = textures_arg(sc.textures, shade_rows is not None,
                         ibl and bool(s.has_sky), keep)
    if shade_rows is None:
        return s, keep
    s.rows, s.n_rows = p(shade_rows), shade_rows.shape[0]
    sun_dir, sun_int = _sun(params, light_on, dev)
    amb = torch.clamp(params.ambient_strength, min=0.2)
    s.uniforms = p(torch.cat([sun_dir, sun_int, amb.reshape(1)]))
    lights = sc.lights
    s.n_lights = lights.count
    if lights.count > 0:
        fi = params.frame_index
        if not isinstance(fi, torch.Tensor):
            fi = torch.full((), int(fi), dtype=torch.int64, device=dev)
        i32 = torch.int32
        s.frame_index = p(fi.to(torch.int64), torch.int64)
        s.n_cdf = lights.cdf.shape[0]
        s.light_inst = p(lights.instance, i32)
        s.light_cdf_start = p(lights.cdf_start, i32)
        s.light_cdf_count = p(lights.cdf_count, i32)
        s.light_env = p(lights.environment, i32)
        s.cdf = p(lights.cdf)
        s.inst_index_offset = p(sc.instances.index_offset, i32)
        s.inst_emission = p(_inst_emission(sc))
        tris = sc.triangles
        s.v0, s.v1, s.v2 = p(tris.v0), p(tris.v1), p(tris.v2)
    return s, keep
