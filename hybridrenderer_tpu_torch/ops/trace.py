"""Ray queries over the scene BVH (hybridrenderer_tpu/ops/trace.py):
``SceneTracer.build``, the visibility queries (``shadow_query`` over
images, ``occluded`` over flat rays) through the any-hit traversal K2,
and ``trace_radiance``, the closest-hit traversal K2c with hit shading
(closesthit.rchit) and the sky on a miss (miss.rmiss). In a scene with
alpha-tested (cut-out) materials every query skips transparent texels
in up to ``ALPHA_ROUNDS`` closest-hit rounds through K2c. With
``trace_backend="pallas"`` all three go through the packet traversal
K2b instead; with ``trace_backend="pallas-wide"`` and ``wide_kernel``
"compressed" or "mimt", through the wide-BVH traversal K2w or K2m.
``refit`` follows a dynamic scene's moved triangles without a rebuild.

The reference relayouts rays tile- or pattern-major for its TPU packets;
a relayout changes no per-ray result, so the per-ray kernels trace in
pixel order. K2b traces image queries in pixel order too: handed the
image's width, it takes one 8x4 pixel tile a packet itself, as K2 / K2c
take one a warp. The wide kernels' packets are 1024 rays, so image
queries take the reference's 32x32 tile-major order for them
(``to_tile_major``, edge-padded).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core import maths
from ..core.types import RenderFlags
from . import sampling, shade, sky, texture
from .bvh import build_sah, refit_bvh, refit_levels
from .bvh_wide import build_wide, refit_wide
from .trace_cuda import (INACTIVE_TRI, PACKET_STACK_DEPTH, STACK_DEPTH,
                         PackedBVH, check_wide_stacks, intersect_any,
                         intersect_closest, intersect_mimt, intersect_packet,
                         intersect_wide, pack_bvh)

TMIN = 0.01  # shadow_query's ray start, past the normal offset
OCCLUSION_TMIN = 1e-3   # occluded's ray start
RADIANCE_TMIN, RADIANCE_TMAX = 0.01, 1e6
HIT_ID_LIMIT = 1 << 29  # ids at or above it are the TPU kernel's sentinels
# The reference's hit shading fetches the attr_rows columns below
# (scene/schema.py _SHADE_COLS), exactly, from a u16 table of at most
# SHADE_ROWS_MAX rows; above it, it switches to a quantized table that
# changes the image and is not ported.
SHADE_COLS = (list(range(6, 15)) + list(range(21, 30)) + list(range(36, 45))
              + list(range(45, 54)) + [66] + list(range(67, 83)))
SHADE_ROWS_MAX = 98304
WIDE_TILE = 32          # K2w / K2m: a 1024-ray packet is a 32x32 tile
# trace_pallas.VMEM_SCENE_BUDGET: above it the reference traces bf16
# records (bvh_wide.quantize_bf16), which change the image
VMEM_SCENE_BUDGET = 96 * 1024 * 1024
ALPHA_ROUNDS = 4        # transparency continuations through cut-out layers
ALPHA_STEP = 1e-3       # how far past a transparent hit a round restarts


def tile_major(H, W, device, tile=WIDE_TILE):
    """The reference's ``to_tile_major`` order as indices: → (the source
    pixel of each traced ray, tile x tile tiles in row-major order, the
    image edge-padded to whole tiles; each pixel's position in that
    order)."""
    ntx, nty = -(-W // tile), -(-H // tile)
    p = torch.arange(nty * ntx * tile * tile, device=device)
    t, r = p // (tile * tile), p % (tile * tile)
    y = torch.clamp((t // ntx) * tile + r // tile, max=H - 1)
    x = torch.clamp((t % ntx) * tile + r % tile, max=W - 1)
    yy = torch.arange(H, device=device).unsqueeze(1)
    xx = torch.arange(W, device=device).unsqueeze(0)
    pos = ((yy // tile) * ntx + xx // tile) * (tile * tile) \
        + (yy % tile) * tile + xx % tile
    return y * W + x, pos.reshape(-1)


def _pixel_order(pos, x, lead):
    """Flat results in traced order → (*lead, ...) in pixel order;
    ``pos`` holds each pixel's traced position (None: pixel order)."""
    if pos is not None:
        x = x[pos]
    return x.reshape(*lead, *x.shape[1:])


def _shade_rows(scene_data):
    cols = torch.tensor(SHADE_COLS, device=scene_data.device)
    return scene_data.attr_rows[:, cols].contiguous()


def wide_kernel_of(settings) -> "str | None":
    """The wide traversal ``settings`` ask for: "compressed" (K2w),
    "mimt" (K2m) or None (K2 / K2c, the reference's direct kernel)."""
    k = None if settings is None else settings.wide_kernel
    return k if k in ("compressed", "mimt") else None


@dataclasses.dataclass
class SceneTracer:
    # K2 / K2c / K2b's packing of the binary tree; None when a wide
    # kernel traces
    packed: "PackedBVH | None"
    # (T, 53) hit-shading rows: vertex k's normal, tangent, uv at 9k;
    # normal matrix at 27, material id at 36, material row at 37
    shade_rows: Any
    # trace_backend "pallas": every query through the packet kernel K2b
    packet: bool = False
    # the scene's TextureStack when it has alpha-tested (cut-out)
    # materials: every query then skips their transparent texels
    cutout: Any = None
    # the binary SAH tree, and its refit order (bvh.refit_levels), taken
    # on the first refit
    bvh: Any = None
    levels: Any = None
    # wide_kernel "compressed" (K2w) or "mimt" (K2m): every query over
    # the 8-wide tree ``wide`` (bvh_wide.WideBVH)
    wide_kernel: "str | None" = None
    wide: Any = None

    @staticmethod
    def build(scene_data, settings=None) -> "SceneTracer":
        """Binned-SAH BVH over the scene's triangle soup, on the scene's
        device, for the traversal ``settings.trace_backend`` and
        ``settings.wide_kernel`` pick. The reference's bf16 wide records,
        which it traces when the f32 records exceed its 96 MiB budget,
        are not ported: the wide kernels raise above it."""
        packet = settings is not None and settings.trace_backend == "pallas"
        kernel = wide_kernel_of(settings)
        soup = scene_data.triangles
        bvh = build_sah(soup.v0, soup.v1, soup.v2)
        packed = wide = None
        if kernel is None:
            packed = pack_bvh(bvh, soup.v0, soup.v1, soup.v2,
                              PACKET_STACK_DEPTH if packet else STACK_DEPTH)
        else:
            wide = build_wide(bvh, soup.v0, soup.v1, soup.v2)
            if wide.vmem_bytes > VMEM_SCENE_BUDGET:
                raise NotImplementedError(
                    f"wide records of {wide.vmem_bytes} bytes exceed the "
                    f"reference's {VMEM_SCENE_BUDGET}-byte budget, above "
                    f"which it traces bf16 records (not ported yet)")
            check_wide_stacks(wide, kernel == "mimt")
        return SceneTracer(packed=packed, shade_rows=_shade_rows(scene_data),
                           packet=packet, bvh=bvh, wide_kernel=kernel,
                           wide=wide, cutout=scene_data.textures
                           if scene_data.has_alpha_test else None)

    def refit(self, scene_data) -> "SceneTracer":
        """The tracer after a dynamic update moved triangles (the
        topology frozen): the binary tree's boxes refit, the records
        repacked on the known topology, or the wide records refit, and the
        hit-shading rows taken anew from the scene's attribute rows. All
        on the scene's device; only the first refit of a tree walks it on
        the host, for the level order it keeps."""
        soup = scene_data.triangles
        levels = self.levels if self.levels is not None \
            else refit_levels(self.bvh)
        bvh = refit_bvh(self.bvh, soup.v0, soup.v1, soup.v2, levels)
        packed = wide = None
        if self.wide is not None:
            wide = refit_wide(self.wide, bvh.node_min, bvh.node_max,
                              soup.v0, soup.v1, soup.v2)
        else:
            packed = pack_bvh(bvh, soup.v0, soup.v1, soup.v2,
                              PACKET_STACK_DEPTH if self.packet
                              else STACK_DEPTH, like=self.packed)
        return dataclasses.replace(self, packed=packed, bvh=bvh,
                                   levels=levels, wide=wide,
                                   shade_rows=_shade_rows(scene_data))

    def _packet_order(self, lead, *rays):
        """The order the wide kernels trace the rays of an (H, W) image
        in, 32x32 tiles → (each traced ray's pixel, each pixel's traced
        position, the flat rays in traced order), or (None, None, rays)
        for pixel order."""
        if len(lead) != 2 or self.wide is None:
            return None, None, rays
        fwd, pos = tile_major(*lead, rays[0].device)
        return fwd, pos, tuple(x[fwd].contiguous() for x in rays)

    def _wide_query(self, o, d, tmin, tmax, active, any_hit):
        """K2w or K2m, with the sentinel of inactive rays mapped to the
        port's miss (t = +inf, tri = -1), as K2 / K2c report them."""
        f = intersect_mimt if self.wide_kernel == "mimt" else intersect_wide
        t, tri, u, v = f(self.wide, o, d, tmin, tmax, active, any_hit)
        inactive = tri == INACTIVE_TRI
        return (torch.where(inactive, float("inf"), t),
                torch.where(inactive, -1, tri), u, v)

    # ``width`` > 0: the rays are an image of that many columns in pixel
    # order, which K2 / K2c trace in 8x4 tiles a warp and K2b in 8x4
    # tiles a packet; the wide kernels ignore it (their rays come in
    # their own order)
    def _any(self, o, d, tmin, tmax, active, width=0):
        if self.wide is not None:
            return self._wide_query(o, d, tmin, tmax, active, True)[1]
        if self.packet:
            return intersect_packet(self.packed, o, d, tmin, tmax, active,
                                    True, width)[1]
        return intersect_any(self.packed, o, d, tmin, tmax, active, width)

    def _closest(self, o, d, tmin, tmax, active, width=0):
        if self.wide is not None:
            return self._wide_query(o, d, tmin, tmax, active, False)
        if self.packet:
            return intersect_packet(self.packed, o, d, tmin, tmax, active,
                                    False, width)
        return intersect_closest(self.packed, o, d, tmin, tmax, active,
                                 width)

    def shadow_rays(self, world_pos, normal, direction, tmax, active=None):
        """The rays of ``shadow_query`` as ``intersect_any`` takes them:
        (o (R, 3), d (R, 3), tmax (R,), active (R,)) with R = H * W."""
        H, W = world_pos.shape[:2]
        dev = world_pos.device
        origin = sampling.offset_ray(world_pos, normal).reshape(-1, 3)
        d = direction.expand(H, W, 3).reshape(-1, 3).contiguous()
        t = torch.full((H * W,), min(float(tmax), 10000.0),
                       dtype=torch.float32, device=dev)
        act = torch.ones((H * W,), dtype=torch.bool, device=dev) \
            if active is None else active.reshape(-1).contiguous()
        return origin.contiguous(), d, t, act

    def shadow_query(self, world_pos, normal, direction, tmax, active=None):
        """Visibility (1.0 unoccluded) over (H, W) images: origins offset
        along the normal, tmin 0.01, tmax capped at 10000. ``active``
        (H, W) masks rays out entirely; they report 1.0."""
        o, d, t, act = self.shadow_rays(world_pos, normal, direction, tmax,
                                        active)
        lead = world_pos.shape[:2]
        _, pos, (o, d, t, act) = self._packet_order(lead, o, d, t, act)
        if self.cutout is not None:
            occ = self._occluded_alpha(o, d, TMIN, t, act, lead[1])
        else:
            occ = self._any(o, d, TMIN, t, act, lead[1]) >= 0
        return _pixel_order(pos, torch.where(occ, 0.0, 1.0), lead)

    def occluded(self, origin, direction, tmax: float, active, width=0):
        """Flat any-hit query, tmin 1e-3: (R, 3) rays → visibility (R,),
        1.0 unoccluded, 0.0 occluded or inactive. ``width`` > 0: the rays
        are images of that many columns, in pixel order. In a cut-out
        scene inactive rays report 1.0, as the reference's alpha rounds
        do; every caller masks them."""
        R = origin.shape[0]
        t = torch.full((R,), float(tmax), dtype=torch.float32,
                       device=origin.device)
        o, d, act = (x.contiguous() for x in (origin, direction, active))
        if self.cutout is not None:
            occ = self._occluded_alpha(o, d, OCCLUSION_TMIN, t, act, width)
            return torch.where(occ, 0.0, 1.0)
        tri = self._any(o, d, OCCLUSION_TMIN, t, act, width)
        return torch.where(active & (tri < 0), 1.0, 0.0)

    def surface_alpha(self, tri, u, v):
        """(is an alpha-tested material, texel alpha, cutoff) at hits:
        the uv and the material row's colour texture (column 10), alpha
        mode (14) and cutoff (15) from the hit-shading rows."""
        safe = torch.clamp(tri, 0, self.shade_rows.shape[0] - 1).long()
        row = self.shade_rows[safe]
        b1, b2 = u.unsqueeze(-1), v.unsqueeze(-1)
        uv = row[:, 7:9] * (1.0 - b1 - b2) + row[:, 16:18] * b1 \
            + row[:, 25:27] * b2
        tex = row[:, 47].to(torch.int32)
        is_mask = (row[:, 51].to(torch.int32) == 1) & (tex >= 0)
        rgba = texture.sample_stack(self.cutout, tex, uv,
                                    (1.0, 1.0, 1.0, 1.0))
        return is_mask, rgba[:, 3], row[:, 52]

    def _occluded_alpha(self, o, d, tmin, tmax, active, width=0):
        """Occlusion that skips transparent cut-out texels: up to
        ALPHA_ROUNDS closest-hit rounds (closest, not any, hits: advancing
        past an arbitrary hit could jump over a nearer opaque one); a
        transparent hit restarts its ray ALPHA_STEP past it with what is
        left of its tmax. Inactive rays take part in no round → (R,)
        bool, True where an opaque texel blocks the ray."""
        occluded = torch.zeros_like(active)
        live = active
        for _ in range(ALPHA_ROUNDS):
            t, tri, u, v = self._closest(o, d, tmin, tmax, live, width)
            hit = live & (tri >= 0)
            is_mask, alpha, cutoff = self.surface_alpha(tri, u, v)
            transparent = hit & is_mask & (alpha < cutoff)
            occluded = occluded | (hit & ~transparent)
            live = transparent
            step = torch.where(live, t + ALPHA_STEP, torch.zeros_like(t))
            o = (o + d * step.unsqueeze(-1)).contiguous()
            tmax = torch.clamp(tmax - step, min=0.0)
        return occluded

    def radiance_rays(self, origin, direction, active=None):
        """The rays of ``trace_radiance`` as ``intersect_closest`` takes
        them: (o (R, 3), d (R, 3), tmax (R,), active (R,))."""
        o = origin.reshape(-1, 3).contiguous()
        d = direction.reshape(-1, 3).contiguous()
        R = o.shape[0]
        act = torch.ones((R,), dtype=torch.bool, device=o.device) \
            if active is None else active.reshape(-1).contiguous()
        t = torch.full((R,), RADIANCE_TMAX, dtype=torch.float32,
                       device=o.device)
        return o, d, t, act

    def trace_radiance(self, scene, origin, direction, ctx, depth: int = 0,
                       active=None):
        """Trace and shade closest hits. origin / direction (..., 3) →
        (rgb (..., 3), hit distance (...) with -1 on a miss). Inactive
        rays trace nothing and take the miss value. The NEE seed of a ray
        is its flat index, the reference's original pixel index, also
        where the wide kernels trace (H, W) rays in tile order."""
        lead = origin.shape[:-1]
        o, d, tmax, act = self.radiance_rays(origin, direction, active)
        fwd, pos, (o, d, tmax, act) = self._packet_order(lead, o, d, tmax,
                                                         act)
        # rays of an (H, W) image stay in pixel order for K2 / K2c / K2b
        width = lead[1] if len(lead) == 2 else 0
        t, tri, u, v = self._closest(o, d, RADIANCE_TMIN, tmax, act, width)
        hit = (tri >= 0) & (tri < HIT_ID_LIMIT) & act
        if self.cutout is not None:
            # transparent cut-out texels are skipped: up to
            # ALPHA_ROUNDS - 1 re-traces past them, the hit distance kept
            # from the original origin
            o_adv, t_off = o, torch.zeros_like(t)
            for _ in range(ALPHA_ROUNDS - 1):
                is_mask, alpha, cutoff = self.surface_alpha(tri, u, v)
                transparent = hit & is_mask & (alpha < cutoff)
                step = torch.where(transparent, t + ALPHA_STEP,
                                   torch.zeros_like(t))
                o_adv = (o_adv + d * step.unsqueeze(-1)).contiguous()
                t_off = t_off + step
                t2, tri2, u2, v2 = self._closest(o_adv, d, RADIANCE_TMIN,
                                                 tmax, transparent, width)
                t = torch.where(transparent, t2, t)
                tri = torch.where(transparent, tri2, tri)
                u = torch.where(transparent, u2, u)
                v = torch.where(transparent, v2, v)
                hit = (tri >= 0) & (tri < HIT_ID_LIMIT) & act
            t = t + t_off
        rgb_hit = self._shade_hit(scene, o, d, t, tri, u, v, ctx, hit, fwd,
                                  width)
        rgb_miss = sky.sample_environment(
            d, scene.sky_texture, scene.textures,
            bool(ctx.settings.flags & RenderFlags.IBL),
            has_sky=scene.has_sky_texture)
        rgb = torch.where(hit.unsqueeze(-1), rgb_hit, rgb_miss)
        dist = torch.where(hit, t, torch.full_like(t, -1.0))
        return _pixel_order(pos, rgb, lead), _pixel_order(pos, dist, lead)

    def _shade_hit(self, sc, o, d, t, tri, u, v, ctx, active, ray_idx=None,
                   width=0):
        """closesthit.rchit: interpolate the hit's attributes, evaluate
        its material, sun and emissive-light NEE (both shadowed, with the
        reference's facing gates), IBL ambient and emission. ``active``
        (the hit mask) gates the occlusion rays; ``ray_idx``, the rays'
        pixel indices (default: their flat index), seeds NEE; ``width``,
        the columns of the image the rays are in pixel order, or 0."""
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
        light_on = bool(flags & RenderFlags.LIGHT)
        sun_dir = maths.normalize(-params.sun_direction).expand(R, 3)
        sun_int = params.sun_color * params.sun_intensity if light_on \
            else torch.zeros(3, device=dev)
        shadow_origin = sampling.offset_ray(world_pos, geo_n)
        sun_brdf = shade.eval_pbr(mp.colour, 1.5, mp.roughness, mp.metallic,
                                  n, view, sun_dir) * sun_int
        # facing gates: a hit facing away from the sun or the sampled
        # light gets no light from it, so its occlusion ray is not traced
        sun_act = None
        if light_on:
            sun_act = (maths.dot(geo_n, sun_dir) > 0.0) & active

        nee_act = None
        if sc.lights.count > 0:
            if ray_idx is None:
                ray_idx = torch.arange(R, dtype=torch.int64, device=dev)
            seed = sampling.init_random_seed(ray_idx, params.frame_index)
            ldir, sampled_inst, _ = sampling.sample_lights(sc, world_pos,
                                                           seed)
            has = (maths.length(ldir) > 0.001) & (maths.dot(geo_n, ldir)
                                                  > 0.0)
            inst_emission = sc.materials.emission[
                sc.instances.material.long()] * 5.0
            l_rad = inst_emission[torch.clamp(sampled_inst, min=0).long()]
            nee = shade.eval_pbr(mp.colour, 1.5, mp.roughness, mp.metallic,
                                 n, view, ldir) * l_rad
            nee_act = has & active

        # the sun and light rays share origins: one any-hit call of 2R
        # rays when both are live
        sun_shadow = torch.zeros((R,), device=dev)
        lshadow = None
        if sun_act is not None and nee_act is not None:
            # two images one above the other: still ``width`` columns
            both = self.occluded(torch.cat([shadow_origin, shadow_origin]),
                                 torch.cat([sun_dir, ldir]), 1000.0,
                                 torch.cat([sun_act, nee_act]), width)
            sun_shadow, lshadow = both[:R], both[R:]
        elif sun_act is not None:
            sun_shadow = self.occluded(shadow_origin, sun_dir, 1000.0,
                                       sun_act, width)
        elif nee_act is not None:
            lshadow = self.occluded(shadow_origin, ldir, 1000.0, nee_act,
                                    width)
        direct = sun_brdf * sun_shadow.unsqueeze(-1)
        if nee_act is not None:
            ok = (has & (lshadow > 0.5) & (sampled_inst >= 0)).unsqueeze(-1)
            direct = direct + torch.where(ok, nee, torch.zeros_like(nee))

        # IBL ambient (closesthit.rchit:99-113)
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
