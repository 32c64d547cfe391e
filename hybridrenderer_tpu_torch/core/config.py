"""Static render configuration (hybridrenderer_tpu/core/config.py).

Only the fields the ported paths read are ported, with the reference's
defaults. The reference's kernel-backend fields (raster_backend,
svgf_backend, svgf_temporal_gather) pick Pallas or jnp by platform;
here the device of the tensors picks the kernel or its plain version, so
they are not fields and passing one raises TypeError. So does passing
gi_layout or ao_layout (relayouts of the TPU's ray packets that change
no result), shade_fetch (an A/B switch of the hit-shading fetch) or
debug_radiance_stage (a diagnostic cut of the radiance pass). Three
kernel choices are settings, because they pick between kernels of the
port: ``trace_backend``, ``wide_kernel`` and ``raster_eval`` (below);
``bvh_builder``, ``raster_attr_bits`` and the wide tree's shape
(``bvh_width``, ``bvh_leaf_tris``) change the image, as in the
reference; ``fuse_shadow_ao`` (the reference's RT_FUSE_SHADOW_AO)
changes no pixel, it fuses two any-hit launches into one. Nothing is
read from the environment.
"""
from __future__ import annotations

import dataclasses

from .types import DisplayMode, RenderFlags, RenderPathType

TRACE_BACKENDS = ("auto", "pallas-wide", "jnp", "pallas")
RASTER_EVALS = (None, "v1", "v2", "v3", "v4")
WIDE_KERNELS = (None, "direct", "compressed", "mimt")
BVH_BUILDERS = ("auto", "sah", "lbvh")
# the reference's wide build takes 8 or 16 children a node
# (ops/bvh_wide.py build_wide) and its r3 ladder 4, 8 or 16 triangles a
# leaf cluster (BENCH.md); None is its default, 8 and 4
BVH_WIDTHS = (None, 8, 16)
BVH_LEAF_TRIS = (None, 4, 8, 16)


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    width: int = 512
    height: int = 512
    path: RenderPathType = RenderPathType.FORWARD
    flags: RenderFlags = RenderFlags.LIGHT | RenderFlags.IBL
    display_mode: DisplayMode = DisplayMode.FINAL

    svgf_atrous_iterations: int = 3
    # SVGF history storage width: 16 (bf16) or 32 (f32)
    svgf_bits: int = 16
    # Back-face culling of opaque single-sided triangles: "back" | "none"
    raster_cull: str = "back"
    # width of the raster kernel's 40 interpolated attribute planes: 32
    # (f32) or 16 (bf16, rounded to nearest; upcast to f32 for the
    # G-buffer math, as the reference's RGBA16F G-buffer targets)
    raster_attr_bits: int = 32

    ao_radius: float = 10.0
    # one AO direction per (ao_block x ao_block) pixel block pattern
    ao_interleaved: bool = True
    ao_block: int = 128
    # per-pixel AO draws (ao_interleaved=False) from the blue-noise
    # texture, else from the TEA hash
    use_blue_noise: bool = True

    # one GI bounce direction per (gi_block x gi_block) pixel block
    # pattern, else per-pixel draws like AO's
    gi_interleaved: bool = True
    gi_block: int = 64
    # reflection rays only where the G-buffer roughness is at most this
    reflection_roughness_cutoff: float = 0.6
    # trace reflection / GI on the half-res grid, then upsample
    reflection_half_res: bool = False
    gi_half_res: bool = False

    # BVH traversal: "pallas" is the packet traversal K2b (one warp of
    # 32 rays shares a stack); "auto", "pallas-wide" and "jnp" are the
    # per-ray K2 / K2c, which compute the reference's intersect_bvh
    trace_backend: str = "auto"
    # with trace_backend "pallas-wide", the traversal of the 8-wide BVH,
    # the reference's environment knobs WIDE_STACK and WIDE_KERNEL read
    # at import: None or "direct" (WIDE_STACK=auto, its direct-stack
    # kernel) run K2 / K2c; "compressed" (WIDE_STACK=compressed) runs
    # K2w; "mimt" (WIDE_KERNEL=mimt) runs K2m
    wide_kernel: "str | None" = None
    # raster winner rule of the ray-traced path's depth prepass: "v2" and
    # "v3" are K1v's 17-bit integer depth keys per 128 candidates; None,
    # "v1" and "v4" are K1's exact depth. The G-buffer pass always runs
    # K1: the reference downgrades v2 / v3 to v1 where attributes ride
    raster_eval: "str | None" = None
    # BVH build: "auto" (= "sah", binned SAH) or "lbvh" (the Karras radix
    # tree, faster to build); both by native/bvh_builder.cpp
    bvh_builder: str = "auto"
    # the 8-wide tree "pallas-wide" builds: children a node (None: 8) and
    # triangles a leaf cluster (None: 4), the reference's bvh_width and
    # bvh_leaf_tris (its WIDE_WIDTH and WIDE_LEAF_TRIS). They size the
    # records, and so the reference's choice of f32 or bf16 triangles
    # and of the kernel that runs (ops/trace.py plan_wide)
    bvh_width: "int | None" = None
    bvh_leaf_tris: "int | None" = None
    # RTShadowPass traces its shadow and AO rays in one any-hit launch of
    # 2R rays (SceneTracer.shadow_query_pair), the reference's
    # RT_FUSE_SHADOW_AO=1; the frame is the same bit for bit
    fuse_shadow_ao: bool = False

    def __post_init__(self):
        if self.svgf_bits not in (16, 32):
            raise ValueError(f"svgf_bits must be 16 or 32, got "
                             f"{self.svgf_bits}")
        if self.raster_attr_bits not in (16, 32):
            raise ValueError(f"raster_attr_bits must be 16 or 32, got "
                             f"{self.raster_attr_bits}")
        if self.bvh_builder not in BVH_BUILDERS:
            raise ValueError(f"bvh_builder must be one of {BVH_BUILDERS}, "
                             f"got {self.bvh_builder!r}")
        if self.trace_backend not in TRACE_BACKENDS:
            raise ValueError(f"trace_backend must be one of "
                             f"{TRACE_BACKENDS}, got {self.trace_backend!r}")
        if self.wide_kernel not in WIDE_KERNELS:
            raise ValueError(f"wide_kernel must be one of {WIDE_KERNELS}, "
                             f"got {self.wide_kernel!r}")
        if self.wide_kernel is not None \
                and self.trace_backend != "pallas-wide":
            raise ValueError(f"wide_kernel={self.wide_kernel!r} needs "
                             f"trace_backend='pallas-wide', got "
                             f"{self.trace_backend!r}")
        if self.raster_eval not in RASTER_EVALS:
            raise ValueError(f"raster_eval must be one of {RASTER_EVALS}, "
                             f"got {self.raster_eval!r}")
        if self.bvh_width not in BVH_WIDTHS:
            raise ValueError(f"bvh_width must be one of {BVH_WIDTHS}, got "
                             f"{self.bvh_width!r}")
        if self.bvh_leaf_tris not in BVH_LEAF_TRIS:
            raise ValueError(f"bvh_leaf_tris must be one of "
                             f"{BVH_LEAF_TRIS}, got {self.bvh_leaf_tris!r}")
        if self.raster_cull not in ("back", "none"):
            raise ValueError(f"raster_cull must be 'back' or 'none', got "
                             f"{self.raster_cull!r}")

    def has(self, flag: RenderFlags) -> bool:
        return bool(self.flags & flag)

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)

    @property
    def resolution(self):
        return (self.height, self.width)
