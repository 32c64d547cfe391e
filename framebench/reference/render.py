"""The reference frame: the hybrid path's image worked out from the
benchmark's arrays alone, in plain PyTorch, with a rasterizer, a tree
and ray queries of its own (raster.py, bvh.py).

A frame: the G-buffer of the jittered view (the pixel's nearest
triangle, its world position, normal, uv, object and motion, the
material's colour times its texture); a sun shadow ray and an
ambient-occlusion ray from every covered pixel; with REFLECTION and
GI, a mirror ray (squared roughness at most the cutoff) and a diffuse
ray, each shaded at its nearest hit from quantized shading rows (the
sun, shadowed, and the sky as ambient) or given the sky where it
leaves; an SVGF chain over each signal; the sun, AO and the radiance
composed over the G-buffer, the sky behind; the tone curve.

A moving scene (``move_to``) places its entities anew and builds its
tree again each frame."""
from __future__ import annotations

import numpy as np
import torch

from . import shading as sh
from . import svgf
from .bvh import Tree
from .camera import Camera
from .raster import rasterize
from .world import World

# the SVGF edge-stopping constants (moments luminance, a-trous
# luminance scale, normal power) and the exposure every frame is given
PHI = (4.0, 128.0, 0.02)
EXPOSURE = 1.0
SHADOW_TMIN, SHADOW_TMAX = 0.01, 10000.0
RADIANCE_TMIN, RADIANCE_TMAX = 0.01, 1e6
HIT_SHADOW_TMIN, HIT_SHADOW_TMAX = 1e-3, 1000.0
HIT_AMBIENT_MIN = 0.2
# the settings the reference implements, with the values it implements
FIXED = dict(ao_interleaved=True, gi_interleaved=True,
             reflection_half_res=False, gi_half_res=False,
             raster_cull="back", raster_attr_bits=32, fuse_shadow_ao=False)
DEFAULTS = dict(ao_radius=10.0, ao_block=128, gi_block=64, svgf_bits=16,
                svgf_atrous_iterations=3, reflection_roughness_cutoff=0.6)
PASSES = {"LIGHT", "IBL", "EMISSIVE", "SHADOW", "AO", "SVGF",
          "SVGF_TEMPORAL", "SVGF_SPATIAL", "REFLECTION", "GI"}


# scenes of more triangles than this, and of at most QUANTIZED_MAX
# triangles and QUANTIZED_ENTITIES entities, shade their ray hits from
# quantized rows; all others from the exact vertex attributes
QUANTIZED_ABOVE = 98304
QUANTIZED_MAX = 16 * 1024 * 1024 // 58
QUANTIZED_ENTITIES = 65536


def _truncated_bf16(x):
    """float32 → the bfloat16 of its upper 16 bits (truncated)."""
    return (x.contiguous().view(torch.int32) & ~0xFFFF).view(torch.float32)


class Reference:
    def __init__(self, cfg: dict, desc, traffic, device):
        r = cfg["render"]
        if r["path"] != "HYBRID":
            raise ValueError(f"the reference renders the HYBRID path, not "
                             f"{r['path']}")
        self.flags = set(r["flags"])
        if not self.flags <= PASSES or not {"SVGF", "SVGF_TEMPORAL",
                                            "SVGF_SPATIAL", "SHADOW", "AO",
                                            "LIGHT", "IBL"} <= self.flags:
            raise ValueError(f"the reference renders the flags {PASSES} "
                             f"with SVGF, shadows, AO, LIGHT and IBL on")
        settings = dict(DEFAULTS, **r.get("settings", {}))
        for k, v in FIXED.items():
            if settings.get(k, v) != v:
                raise ValueError(f"the reference implements {k}={v!r}")
        self.s = settings
        self.width, self.height = int(r["width"]), int(r["height"])
        self.traffic = traffic
        self.world = World(desc, device)
        self.device = device
        self.tree = None
        self.history, self.prev, self.frame_index = {}, None, 0
        w = self.world
        # the shading rows of each triangle's corners: in a quantized
        # scene the local normals as truncated bfloat16, uv0 exactly and
        # the other corners' uv as uv0 plus a float16 step
        c_uv, c_n = w.corners(w.uv), w.corners(w.local_nrm)
        T, E = w.tris.shape[0], len(desc.meshes)
        if QUANTIZED_ABOVE < T <= QUANTIZED_MAX and E <= QUANTIZED_ENTITIES:
            c_uv = torch.cat([c_uv[:, :1], c_uv[:, :1] + (
                c_uv[:, 1:] - c_uv[:, :1]).half().float()], dim=1)
            c_n = _truncated_bf16(c_n)
        self.hit_uv, self.hit_nrm = c_uv, c_n

    def move_to(self, k: int):
        """The scene as it stands for frame k: moved entities at their
        transforms of frame k."""
        moved = self.traffic.transforms(k)
        if moved:
            self.world.move(moved)
            self.tree = None

    # --- passes ------------------------------------------------------------

    def _gbuffer(self, cam):
        w = self.world
        H, W = self.height, self.width
        ones = torch.ones_like(w.world_pos[:, :1])
        clip = torch.cat([w.world_pos, ones], -1) @ cam.view_proj.T
        jit = torch.as_tensor(cam.jitter.astype(np.float32), device=clip.device)
        clip = torch.cat([clip[:, :2] + jit * clip[:, 3:4], clip[:, 2:]], -1)
        tri, lam, depth = rasterize(clip, w.tris, W, H, cam.near,
                                    single_sided=w.tri_single_sided)
        fg = tri >= 0
        t = torch.clamp(tri, min=0)
        total = torch.where(fg, lam.sum(-1), torch.ones_like(depth).double())
        mu = torch.where(fg.unsqueeze(-1), lam / total.unsqueeze(-1),
                         torch.zeros_like(lam))

        def lerp(per_vertex):
            c = w.corners(per_vertex)[t].double()          # (H, W, 3, C)
            return (c * mu.unsqueeze(-1)).sum(-2).float()

        pos, prev_pos = lerp(w.world_pos), lerp(w.prev_world_pos)
        normal = sh.unit(lerp(w.world_nrm))
        uv = lerp(w.uv)
        z = torch.where(fg, (1.0 / total).float(), torch.zeros_like(depth))
        mat = w.tri_material[t]
        albedo = w.mat_colour[mat]
        if w.textures is not None:
            albedo = albedo * sh.texture_rgb(w.textures, w.mat_texture[mat],
                                             uv)

        def to_uv(m, p):
            h = torch.cat([p, torch.ones_like(p[..., :1])], -1) @ m.T
            hw = h[..., 3:4]
            hw = torch.where(hw.abs() < 1e-6, torch.full_like(hw, 1e-6), hw)
            return h[..., :2] / hw * 0.5 + 0.5

        motion = to_uv(cam.view_proj, pos) - to_uv(cam.prev_view_proj,
                                                   prev_pos)
        dzdx = torch.cat([z[:, 1:] - z[:, :-1], torch.zeros_like(z[:, :1])],
                         dim=1)
        f3 = fg.unsqueeze(-1)

        def mask(x):
            return torch.where(f3 if x.dim() == 3 else fg, x,
                               torch.zeros_like(x))

        return dict(fg=fg, pos=mask(pos), normal=mask(normal),
                    albedo=mask(albedo), rough2=mask(w.mat_rough2[mat]),
                    metal=mask(w.mat_metal[mat]),
                    emission=mask(w.mat_emission[mat]),
                    geo=svgf.Geometry(normal=mask(normal),
                                      object_id=torch.where(
                                          fg, w.tri_entity[t], -1),
                                      z=z, dzdx=mask(dzdx),
                                      motion=mask(motion),
                                      albedo=mask(albedo)))

    def _tree(self):
        if self.tree is None:
            c = self.world.corners(self.world.world_pos)
            self.tree = Tree(c[:, 0], c[:, 1], c[:, 2])
        return self.tree

    def _visible(self, origin, d, tmax: float, active):
        """(H, W) 1 where nothing lies along the rays within [0.01,
        tmax], else 0; 1 on inactive rays."""
        H, W = active.shape
        R = H * W
        _, tri, _, _ = self._tree().query(
            origin.reshape(R, 3), d.expand(H, W, 3).reshape(R, 3).contiguous(),
            SHADOW_TMIN, torch.full((R,), min(tmax, SHADOW_TMAX),
                                    device=self.device),
            active.reshape(R), any_hit=True)
        return torch.where(tri.view(H, W) >= 0, 0.0, 1.0)

    def _radiance(self, origin, d, active):
        """The light arriving along the rays (H, W, 3): shaded at the
        nearest hit, else the sky."""
        H, W = active.shape
        R = H * W
        w = self.world
        o, dd = origin.reshape(R, 3), d.reshape(R, 3).contiguous()
        t, tri, u, v = self._tree().query(
            o, dd, RADIANCE_TMIN,
            torch.full((R,), RADIANCE_TMAX, device=self.device),
            active.reshape(R), any_hit=False)
        hit = tri >= 0
        k = torch.clamp(tri, min=0)
        bary = torch.stack([1.0 - u - v, u, v], -1).unsqueeze(-1)
        local_n = (self.hit_nrm[k] * bary).sum(1)
        uv = (self.hit_uv[k] * bary).sum(1)
        ent = w.tri_entity[k]
        geo_n = sh.unit(torch.einsum("rij,rj->ri", w.normal_matrix[ent],
                                     local_n))
        geo_n = torch.where(sh.dot(geo_n, dd, keep=True) > 0, -geo_n, geo_n)
        mat = w.tri_material[k]
        colour = w.mat_colour[mat]
        if w.textures is not None:
            colour = colour * sh.texture_rgb(w.textures, w.mat_texture[mat],
                                             uv)
        rough2, metal = w.mat_rough2[mat], w.mat_metal[mat]
        n = sh.unit(geo_n)
        view = -dd
        p = o + dd * t.unsqueeze(-1)
        to_sun = w.to_sun.expand(R, 3)
        sun_ok = (sh.dot(geo_n, to_sun) > 0) & hit
        _, blocker, _, _ = self._tree().query(
            sh.offset_origin(p, geo_n), to_sun.contiguous(),
            HIT_SHADOW_TMIN, torch.full((R,), HIT_SHADOW_TMAX,
                                        device=self.device),
            sun_ok, any_hit=True)
        lit = (sun_ok & (blocker < 0)).float().unsqueeze(-1)
        direct = sh.brdf_cos(colour, rough2, metal, n, view, to_sun) \
            * w.sun_radiance * lit
        spec0 = 0.04 + (colour - 0.04) * metal.unsqueeze(-1)
        f = sh.fresnel(spec0, n, view)
        kd = (1.0 - f) * (1.0 - metal.unsqueeze(-1))
        refl = dd - 2.0 * sh.dot(n, dd, keep=True) * n
        ambient = (kd * sh.sky(n) * colour + f * sh.sky(refl)) \
            * max(w.ambient, HIT_AMBIENT_MIN)
        rgb = torch.where(hit.unsqueeze(-1),
                          direct + ambient + w.mat_emission[mat], sh.sky(dd))
        return rgb.view(H, W, 3)

    # --- the frame ---------------------------------------------------------

    @torch.no_grad()
    def frame(self, k: int, guide=None) -> dict:
        """Frame k: the scene's update, then the frame over the carried
        history → the image (H, W, 3) f32 and the planes compare.py
        reads. ``guide``: the program's planes of frame k (object_id,
        normal, motion: uv motion, linear depth, its x gradient), which
        the SVGF filters then weigh neighbours by in place of the
        reference's own."""
        self.move_to(k)
        cam = Camera(*self.traffic.camera(k), device=self.device)
        g = self._gbuffer(cam)
        fg, n, pos = g["fg"], g["normal"], g["pos"]
        fi = self.frame_index
        origin = sh.offset_origin(pos, n)
        shadow = self._visible(origin, self.world.to_sun, SHADOW_TMAX, fg)
        ao_dir = sh.pattern_directions(fi, n, int(self.s["ao_block"]),
                                       sh.AO_SALT)
        ao = self._visible(origin, ao_dir, float(self.s["ao_radius"]), fg)
        one = torch.ones_like(ao)
        signals = {"shadow_ao": torch.stack(
            [torch.where(fg, shadow, one), torch.where(fg, ao, one),
             torch.zeros_like(ao), one], -1)}
        zero3 = torch.zeros_like(pos)
        if "REFLECTION" in self.flags:
            eye = sh.unit(pos - cam.position)
            rd = eye - 2.0 * sh.dot(n, eye, keep=True) * n
            cut = (g["rough2"] > float(self.s["reflection_roughness_cutoff"])) \
                | ~fg
            rad = self._radiance(origin, rd, ~cut)
            signals["reflection"] = torch.cat(
                [torch.where(cut.unsqueeze(-1), zero3, rad),
                 one.unsqueeze(-1)], -1)
        if "GI" in self.flags:
            gd = sh.pattern_directions(fi, n, int(self.s["gi_block"]),
                                       sh.GI_SALT)
            rad = self._radiance(origin, gd, fg)
            signals["gi"] = torch.cat(
                [torch.where(fg.unsqueeze(-1), rad, zero3),
                 one.unsqueeze(-1)], -1)

        geo = g["geo"]
        if guide is not None:
            m = guide["motion"].to(self.device)
            geo = svgf.Geometry(normal=guide["normal"].to(self.device),
                                object_id=guide["object_id"].to(self.device),
                                z=m[..., 2], dzdx=m[..., 3],
                                motion=m[..., :2], albedo=geo.albedo)
        store = torch.bfloat16 if int(self.s["svgf_bits"]) == 16 \
            else torch.float32
        out, history = {}, {}
        for name, sig in signals.items():
            out[name], history[name] = svgf.denoise(
                sig, self.history.get(name) if self.prev is not None
                else None, self.prev, geo, name != "shadow_ao",
                int(self.s["svgf_atrous_iterations"]), PHI, store)
        self.history, self.prev = history, geo
        self.frame_index += 1
        own = g["geo"]
        return dict(image=self._compose(g, cam, out),
                    object_id=own.object_id, normal=own.normal, depth=own.z,
                    **{name: m[..., 0] for name, (_, m) in history.items()})

    def _compose(self, g, cam, den):
        w = self.world
        fg = g["fg"]
        albedo, rough2, metal = g["albedo"], g["rough2"], g["metal"]
        up = torch.tensor([0.0, 1.0, 0.0], device=self.device)
        n = sh.unit(torch.where(fg.unsqueeze(-1), g["normal"],
                                up.expand_as(g["normal"])))
        v = sh.unit(cam.position - g["pos"])
        to_sun = w.to_sun.expand_as(v)
        shadow, ao = den["shadow_ao"][..., 0], den["shadow_ao"][..., 1]
        direct = sh.brdf_cos(albedo, rough2, metal, n, v, to_sun) \
            * shadow.unsqueeze(-1) * w.sun_radiance
        spec0 = 0.04 + (albedo - 0.04) * metal.unsqueeze(-1)
        f = sh.fresnel(spec0, n, v)
        kd = (1.0 - f) * (1.0 - metal.unsqueeze(-1))
        if "gi" in den:
            diffuse = den["gi"][..., :3] * albedo * kd
        else:
            diffuse = w.ambient * albedo * ao.unsqueeze(-1) * 0.1
        specular = den["reflection"][..., :3] * f if "reflection" in den \
            else torch.zeros_like(albedo)
        colour = direct + diffuse + specular + g["emission"]
        background = sh.sky(cam.pixel_rays(self.height, self.width))
        return sh.tone(torch.where(fg.unsqueeze(-1), colour, background),
                       EXPOSURE)
