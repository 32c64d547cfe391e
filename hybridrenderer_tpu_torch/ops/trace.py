"""Ray queries over the scene BVH (hybridrenderer_tpu/ops/trace.py):
``SceneTracer.build``, the visibility queries (``shadow_query`` over
images, ``occluded`` over flat rays) through the any-hit traversal K2,
and ``trace_radiance``, the closest-hit traversal K2c with hit shading
(closesthit.rchit) and the sky on a miss (miss.rmiss). The shading runs
in two stages around the hit's occlusion query (ops/shade_cuda.py): a
prepare stage writes the sun and NEE occlusion rays and the unshadowed
terms, ``occluded`` traces the rays, and a finish stage adds the
shadowed terms or the sky and writes the result in pixel order; on the
card each stage is one kernel. In a scene with
alpha-tested (cut-out) materials every query skips transparent texels
in up to ``ALPHA_ROUNDS`` closest-hit rounds through K2c. With
``trace_backend="pallas"`` all three go through the packet traversal
K2b instead; with ``trace_backend="pallas-wide"`` and ``wide_kernel``
"compressed" or "mimt", through the wide-BVH traversal K2w or K2m.
``refit`` follows a dynamic scene's moved triangles without a rebuild.

Large scenes take the reference's decisions on its numbers. Hit
shading reads the quantized rows of scene/schema.py above 98,304
triangles (``schema.shade_table_kind``). Under "pallas-wide" the wide
records (``bvh_width`` children a node, ``bvh_leaf_tris`` triangles a
cluster; 8 and 4 by default) are measured against the reference's
96 MiB budget (``plan_wide``): above it the traced triangles are its
bf16 ones, K2w gives way to K2 / K2c once its meta table exceeds
900 KiB, leaf records stream or the tree is 16 wide, K2m whenever the
records are bf16 or the tree is not 8 wide with 4-triangle clusters,
and beyond even bf16 node records the exact f32 traversal runs. "auto",
"jnp" and "pallas" trace the exact triangles at every size.

``shadow_query_pair`` traces two any-hit queries from the same surface
points in one launch of 2R rays (RTShadowPass under
``fuse_shadow_ao``).

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
from typing import Any, NamedTuple

import torch

from ..core import maths
from ..scene import schema
from ..scene.schema import SHADE_COLS
from . import sampling, shade_cuda, texture
from .bvh import build_bvh, refit_bvh, refit_levels
from .bvh_wide import build_wide, quantize_bf16, quantize_triangles, refit_wide
from .trace_cuda import (INACTIVE_TRI, PACKET_STACK_DEPTH, STACK_DEPTH,
                         PackedBVH, check_wide_stacks, intersect_any,
                         intersect_closest, intersect_mimt, intersect_packet,
                         intersect_wide, pack_bvh)

TMIN = 0.01  # shadow_query's ray start, past the normal offset
OCCLUSION_TMIN = 1e-3   # occluded's ray start
RADIANCE_TMIN, RADIANCE_TMAX = 0.01, 1e6
HIT_ID_LIMIT = 1 << 29  # ids at or above it are the TPU kernel's sentinels
WIDE_TILE = 32          # K2w / K2m: a 1024-ray packet is a 32x32 tile
# trace_pallas.VMEM_SCENE_BUDGET and META_SMEM_LIMIT: the reference's
# 8-wide records against its VMEM budget, and the meta table K2w's TPU
# kernel keeps in SMEM
VMEM_SCENE_BUDGET = 96 * 1024 * 1024
META_SMEM_LIMIT = 900 * 1024
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
    """The (T, 53) hit-shading rows: decoded from the quantized table
    where the scene has one, else the exact attr_rows columns."""
    q = scene_data.shade_rows_q
    if q is not None:
        side = scene_data.inst_shade
        inst = torch.clamp(q[:, schema.SHQ_INST].long(), 0,
                           side.shape[0] - 1)
        return schema.decode_shade_rows_q(q, side[inst]).contiguous()
    cols = maths.constant(tuple(SHADE_COLS), scene_data.device, torch.int64)
    return scene_data.attr_rows[:, cols].contiguous()


def _alpha_uv(scene_data):
    """The exact uv of each triangle's corners, (T, 6), which the alpha
    test reads where the hit-shading rows hold quantized ones (the
    reference's surface_alpha reads attr_rows); None elsewhere."""
    if scene_data.shade_rows_q is None or not scene_data.has_alpha_test:
        return None
    return scene_data.attr_rows[:, [13, 14, 28, 29, 43, 44]].contiguous()


def wide_kernel_of(settings) -> "str | None":
    """The wide traversal ``settings`` ask for: "compressed" (K2w),
    "mimt" (K2m) or None (K2 / K2c, the reference's direct kernel)."""
    k = None if settings is None else settings.wide_kernel
    return k if k in ("compressed", "mimt") else None


def builder_of(settings) -> str:
    """The BVH builder ``settings`` ask for: "sah" (also for "auto") or
    "lbvh"."""
    builder = "auto" if settings is None else settings.bvh_builder
    return "sah" if builder == "auto" else builder


def wide_shape_of(settings) -> tuple:
    """The wide tree ``settings`` ask for → (children a node, triangles
    a leaf cluster), the reference's defaults 8 and 4 for None."""
    width = None if settings is None else settings.bvh_width
    leaf_tris = None if settings is None else settings.bvh_leaf_tris
    return (8 if width is None else width,
            4 if leaf_tris is None else leaf_tris)


def request_of(settings, num_triangles: int) -> tuple:
    """What a tracer built for ``settings`` over ``num_triangles``
    triangles depends on: the packet kernel or not, the wide kernel asked
    for, the BVH builder, and under "pallas-wide" whether it may trace
    bf16 triangles there and, where a wide kernel is asked for or it
    may, the wide tree's shape. Its records take at
    most a wide node (6 f32 a child) and a leaf cluster (12 f32 a
    triangle slot) a triangle, in tiles of 128: below VMEM_SCENE_BUDGET
    "auto", "jnp" and "pallas-wide" build the same tracer."""
    backend = "auto" if settings is None else settings.trace_backend
    kernel = wide_kernel_of(settings)
    width, leaf_tris = wide_shape_of(settings)
    may_quantize = backend == "pallas-wide" and 4 * (num_triangles + 128) \
        * (6 * width + 12 * leaf_tris) > VMEM_SCENE_BUDGET
    # the shape changes nothing where no wide kernel is asked for and the
    # triangles stay f32
    shaped = backend == "pallas-wide" and (kernel is not None
                                           or may_quantize)
    return (backend == "pallas", kernel, builder_of(settings),
            (width, leaf_tris) if shaped else None, may_quantize)


def plan_wide(wide, kernel):
    """The reference's choice over its wide records
    (ops/trace.py:284-327) for the wide kernel asked for → (the wide
    kernel that runs, None for K2 / K2c; whether the traced triangles are
    bf16; why the kernel asked for does not run, or None). Above
    VMEM_SCENE_BUDGET the records are quantized; where the bf16 records
    still exceed it but their node records do not, the reference streams
    the leaf records, and beyond that it traces the exact f32 triangles
    (its jnp fallback, the port's K2 / K2c). K2w runs only over an 8-wide
    tree while neither streaming nor its meta table exceeds
    META_SMEM_LIMIT; K2m only over f32 records of an 8-wide tree with
    4-triangle clusters (the reference packs its p8 layout for those
    alone)."""
    quantized = wide.vmem_bytes > VMEM_SCENE_BUDGET
    stream = False
    if quantized:
        # bf16 halves the records
        if wide.vmem_bytes // 2 > VMEM_SCENE_BUDGET:
            if 2 * wide.nodes_flat.numel() > VMEM_SCENE_BUDGET:
                return None, False, (
                    f"exact traversal: even the bf16 node records exceed "
                    f"the {VMEM_SCENE_BUDGET}-byte budget")
            stream = True
    why = None
    if kernel == "compressed" and (
            stream or wide.width != 8
            or 4 * wide.meta.numel() > META_SMEM_LIMIT):
        why = "leaf records streamed" if stream else \
            f"a {wide.width}-wide tree" if wide.width != 8 else \
            f"meta table of {4 * wide.meta.numel()} bytes above " \
            f"{META_SMEM_LIMIT}"
    elif kernel == "mimt" and (stream or quantized or wide.width != 8
                               or wide.leaf_tris != 4):
        why = "leaf records streamed" if stream else "bf16 records" \
            if quantized else f"{wide.width}-wide nodes with " \
            f"{wide.leaf_tris}-triangle clusters"
    if why is not None:
        return None, quantized, f"{kernel} runs as K2 / K2c: {why}"
    return kernel, quantized, None


class RadianceHits(NamedTuple):
    """``SceneTracer.radiance_hits``: R traced rays and their hits."""
    lead: tuple     # the rays' leading shape
    o: Any          # (R, 3) f32, in traced order
    d: Any          # (R, 3) f32
    t: Any          # (R,) f32 hit distance from o
    tri: Any        # (R,) i32 hit triangle
    u: Any          # (R,) f32 barycentrics
    v: Any
    hit: Any        # (R,) bool: active rays that hit a triangle
    fwd: Any        # (R,) i64 each traced ray's pixel, or None (pixel order)
    pos: Any        # (P,) i64 each pixel's traced position, or None
    width: int      # the image's columns where traced in pixel order, or 0


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
    # the binary tree, and its refit order (bvh.refit_levels), taken on
    # the first refit; over a quantized scene's K2 / K2c its boxes hold
    # the bf16 triangles
    bvh: Any = None
    levels: Any = None
    # wide_kernel "compressed" (K2w) or "mimt" (K2m): every query over
    # the 8-wide tree ``wide`` (bvh_wide.WideBVH)
    wide_kernel: "str | None" = None
    wide: Any = None
    # the traced triangles are the reference's bf16 ones (plan_wide)
    quantized: bool = False
    # the traversal family after the reference's resolution: the
    # trace_backend asked for, or "jnp" where plan_wide falls back to the
    # exact traversal
    backend: str = "auto"
    # why the wide kernel asked for does not run (plan_wide), or None
    demotion: "str | None" = None
    # the f32 8-wide records' bytes plan_wide measured (0: none built)
    wide_bytes: int = 0
    # the exact corner uv the alpha test reads (_alpha_uv), or None
    alpha_uv: Any = None
    # request_of of the settings and scene the tracer was built for
    request: tuple = ()

    @staticmethod
    def build(scene_data, settings=None) -> "SceneTracer":
        """BVH over the scene's triangle soup (binned SAH, or the LBVH
        with ``bvh_builder="lbvh"``), on the scene's device, for the
        traversal ``settings.trace_backend`` and ``settings.wide_kernel``
        pick, under the reference's size rules (``plan_wide``)."""
        backend = "auto" if settings is None else settings.trace_backend
        packet = backend == "pallas"
        kernel = wide_kernel_of(settings)
        soup = scene_data.triangles
        v0, v1, v2 = soup.v0, soup.v1, soup.v2
        bvh = build_bvh(v0, v1, v2, builder_of(settings))
        packed = wide = levels = edges = None
        quantized, demotion, wide_bytes = False, None, 0
        if backend == "pallas-wide":
            width, leaf_tris = wide_shape_of(settings)
            wide = build_wide(bvh, v0, v1, v2, leaf_tris=leaf_tris,
                              width=width)
            wide_bytes = wide.vmem_bytes
            kernel, quantized, demotion = plan_wide(wide, kernel)
            if demotion is not None and demotion.startswith("exact"):
                backend = "jnp"
            if kernel is None:
                wide = None
            elif quantized:
                wide = quantize_bf16(wide)
        if kernel is None:
            if quantized:
                # the reference's direct kernel over bf16 leaves: K2 / K2c
                # trace the same rounded triangles, in boxes that hold them
                v0, e1, e2 = quantize_triangles(v0, v1, v2)
                v1, v2, edges = v0 + e1, v0 + e2, (e1, e2)
                levels = refit_levels(bvh)
                bvh = refit_bvh(bvh, v0, v1, v2, levels)
            packed = pack_bvh(bvh, v0, v1, v2,
                              PACKET_STACK_DEPTH if packet else STACK_DEPTH,
                              edges=edges)
        else:
            check_wide_stacks(wide, kernel == "mimt")
        return SceneTracer(packed=packed, shade_rows=_shade_rows(scene_data),
                           packet=packet, bvh=bvh, levels=levels,
                           wide_kernel=kernel, wide=wide,
                           cutout=scene_data.textures
                           if scene_data.has_alpha_test else None,
                           quantized=quantized, backend=backend,
                           demotion=demotion, wide_bytes=wide_bytes,
                           alpha_uv=_alpha_uv(scene_data),
                           request=request_of(settings, soup.count))

    def refit(self, scene_data) -> "SceneTracer":
        """The tracer after a dynamic update moved triangles (the
        topology frozen): the binary tree's boxes refit, the records
        repacked on the known topology, or the wide records refit (and
        quantized again where they are bf16), and the hit-shading rows
        taken anew from the scene. All on the scene's device; only the
        first refit of a tree walks it on the host, for the level order
        it keeps."""
        soup = scene_data.triangles
        levels = self.levels if self.levels is not None \
            else refit_levels(self.bvh)
        v0, v1, v2 = soup.v0, soup.v1, soup.v2
        edges = None
        if self.quantized and self.wide is None:
            v0, e1, e2 = quantize_triangles(v0, v1, v2)
            v1, v2, edges = v0 + e1, v0 + e2, (e1, e2)
        bvh = refit_bvh(self.bvh, v0, v1, v2, levels)
        packed = wide = None
        if self.wide is not None:
            wide = refit_wide(self.wide, bvh.node_min, bvh.node_max,
                              v0, v1, v2)
        else:
            packed = pack_bvh(bvh, v0, v1, v2,
                              PACKET_STACK_DEPTH if self.packet
                              else STACK_DEPTH, like=self.packed, edges=edges)
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

    def shadow_query_pair(self, world_pos, normal, dir_a, tmax_a, dir_b,
                          tmax_b, active=None):
        """Two ``shadow_query`` calls from the same surface points (the
        sun or light shadow and AO) in one any-hit launch of 2R rays with
        per-ray tmax → (vis_a, vis_b), equal to the two calls' (any-hit
        visibility does not depend on the launch). Each query's tmax is a
        number, capped at 10000 over its half, as the reference's."""
        o, da, ta, act = self.shadow_rays(world_pos, normal, dir_a, tmax_a,
                                          active)
        _, db, tb, _ = self.shadow_rays(world_pos, normal, dir_b, tmax_b,
                                        active)
        lead = world_pos.shape[:2]
        _, pos, (o, da, db, ta, tb, act) = self._packet_order(
            lead, o, da, db, ta, tb, act)
        R = o.shape[0]
        # two images one above the other: still ``lead[1]`` columns
        o2, d2 = torch.cat([o, o]), torch.cat([da, db])
        t2, a2 = torch.cat([ta, tb]), torch.cat([act, act])
        if self.cutout is not None:
            occ = self._occluded_alpha(o2, d2, TMIN, t2, a2, lead[1])
        else:
            occ = self._any(o2, d2, TMIN, t2, a2, lead[1]) >= 0
        vis = torch.where(occ, 0.0, 1.0)
        return (_pixel_order(pos, vis[:R], lead),
                _pixel_order(pos, vis[R:], lead))

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
        if self.alpha_uv is None:
            uv = row[:, 7:9] * (1.0 - b1 - b2) + row[:, 16:18] * b1 \
                + row[:, 25:27] * b2
        else:
            c = self.alpha_uv[safe]
            uv = c[:, 0:2] * (1.0 - b1 - b2) + c[:, 2:4] * b1 \
                + c[:, 4:6] * b2
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

    def radiance_hits(self, origin, direction, active=None) -> RadianceHits:
        """The closest hits of ``trace_radiance``'s rays, in the order
        they are traced (K2c, or the wide kernels' tiles), past the
        transparent texels of a cut-out scene."""
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
        return RadianceHits(lead, o, d, t, tri, u, v, hit, fwd, pos, width)

    def trace_radiance(self, scene, origin, direction, ctx, depth: int = 0,
                       active=None, row0: int = 0):
        """Trace and shade closest hits. origin / direction (..., 3) →
        (rgb (..., 3), hit distance (...) with -1 on a miss). Inactive
        rays trace nothing and take the miss value. The NEE seed of a ray
        is its flat index, the reference's original pixel index, also
        where the wide kernels trace (H, W) rays in tile order; (H, W)
        rays that are rows ``row0`` on of an image take that image's
        index (the reference's ``pix_offset``). The shading is
        ops/shade_cuda.py's two stages around the sun and light rays'
        occlusion query, one any-hit call of 2R rays when both are live
        (two images one above the other: still ``width`` columns)."""
        h = self.radiance_hits(origin, direction, active)
        rgb, dist = shade_cuda.shade_radiance(
            self, scene, h.o, h.d, h.t, h.tri, h.u, h.v, h.hit, ctx, h.fwd,
            row0 * h.lead[1] if row0 else 0, h.width, h.pos)
        return rgb.reshape(*h.lead, 3), dist.reshape(h.lead)
