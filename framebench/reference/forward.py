"""The reference frame of the FORWARD path (ForwardRenderPath: forward
pass, TAA, post-process), worked out from the benchmark's arrays alone,
in plain PyTorch and float32, with the hybrid reference's rasterizer,
tree and shading (render.py, raster.py, bvh.py, shading.py).

A frame: the G-buffer of the jittered view, as render.py makes it; a
sun shadow ray from every covered pixel, to 1000 units; the sun's PBR
term (diffuse + GGX specular, times the cosine) times that shadow;
ambient light, the sky along the normal times the albedo and the
diffuse share kd, plus the sky along the reflected view ray times the
Fresnel term, all times the ambient strength; the material's emission;
the sky behind the geometry. Then TAA's resolve against the colour the
frame before resolved (taa.py), and the tone curve.

Departures from the JAX package's forward pass: none in the shading
(its display modes other than the final image are not implemented);
TAA's as taa.py says. TAA's velocity dilation picks each pixel's
nearest neighbour by the program's reversed-Z depth (``guide``'s
``device_depth``, the plane its raster wrote), as the hybrid
reference's SVGF weighs neighbours by the program's planes: the
program's depths and the reference's differ in their last places (up to
a few 1e-4 relative at the check's sizes), and on a floor seen at a
grazing angle that changes which neighbour's motion a pixel takes
(0.03 on a pixel of the image with the reference's own). That plane
is not judged itself; the program's linear depth, which its G-buffer
works out from it, is, by ``depth_p999``. The motion, the colours and
the history are the reference's own. Without a guide the reference
takes its own depth."""
from __future__ import annotations

import torch

from . import shading as sh
from . import taa
from .camera import Camera
from .render import EXPOSURE, FIXED
from .render import Reference as Hybrid
from .world import World

SHADOW_TMAX = 1000.0
FLAGS = {"LIGHT", "IBL", "EMISSIVE", "SHADOW", "TAA"}
# the settings the forward frame reads, with the values it implements
SETTINGS = {k: FIXED[k] for k in ("raster_cull", "raster_attr_bits")}


class Reference(Hybrid):
    """Shares the hybrid reference's G-buffer (``_gbuffer``), tree
    (``_tree``), shadow rays (``_visible``) and scene motion
    (``move_to``); its own frame."""

    def __init__(self, cfg: dict, desc, traffic, device):
        r = cfg["render"]
        if r["path"] != "FORWARD":
            raise ValueError(f"this reference renders the FORWARD path, not "
                             f"{r['path']}")
        if set(r["flags"]) != FLAGS:
            raise ValueError(f"the forward reference renders the flags "
                             f"{sorted(FLAGS)}, all on")
        for k, v in r.get("settings", {}).items():
            if k not in SETTINGS or v != SETTINGS[k]:
                raise ValueError(f"the forward reference implements only "
                                 f"{SETTINGS}, not {k}={v!r}")
        self.width, self.height = int(r["width"]), int(r["height"])
        self.traffic = traffic
        self.world = World(desc, device)
        self.device = device
        self.tree = None
        self.history = None

    def shade(self, g, cam):
        """The forward pass's colour (H, W, 3) over the G-buffer ``g``:
        sun, shadow, ambient and emission, the sky behind."""
        w = self.world
        fg = g["fg"]
        albedo, rough2, metal = g["albedo"], g["rough2"], g["metal"]
        up = torch.tensor([0.0, 1.0, 0.0], device=self.device)
        n = sh.unit(torch.where(fg.unsqueeze(-1), g["normal"],
                                up.expand_as(g["normal"])))
        v = sh.unit(cam.position - g["pos"])
        to_sun = w.to_sun.expand_as(v)
        lit = self._visible(sh.offset_origin(g["pos"], n), w.to_sun,
                            SHADOW_TMAX, fg)
        direct = sh.brdf_cos(albedo, rough2, metal, n, v, to_sun) \
            * lit.unsqueeze(-1) * w.sun_radiance
        spec0 = 0.04 + (albedo - 0.04) * metal.unsqueeze(-1)
        f = sh.fresnel(spec0, n, v)
        kd = (1.0 - f) * (1.0 - metal.unsqueeze(-1))
        mirror = 2.0 * sh.dot(n, v, keep=True) * n - v
        ambient = (kd * sh.sky(n) * albedo + f * sh.sky(mirror)) * w.ambient
        colour = direct + ambient + g["emission"]
        background = sh.sky(cam.pixel_rays(self.height, self.width))
        return torch.where(fg.unsqueeze(-1), colour, background)

    @torch.no_grad()
    def frame(self, k: int, guide=None) -> dict:
        """Frame k: the scene's update, the forward pass, TAA over the
        carried history, the tone curve → the image (H, W, 3) f32 and the
        planes compare.py reads. ``guide``: the program's planes of frame
        k, whose reversed-Z depth (``device_depth``) TAA's dilation then
        compares in place of the reference's own."""
        self.move_to(k)
        view = self.traffic.camera(k)
        cam = Camera(*view, device=self.device)
        g = self._gbuffer(cam)
        geo = g["geo"]
        if guide is None:
            nearness = torch.where(geo.z > 0, 1.0 / geo.z,
                                   torch.zeros_like(geo.z))
        else:
            nearness = guide["device_depth"].to(self.device)
        self.history = taa.resolve(self.shade(g, cam), self.history,
                                   geo.motion, nearness, view[4], view[5])
        return dict(image=sh.tone(self.history, EXPOSURE),
                    object_id=geo.object_id, normal=geo.normal, depth=geo.z)
