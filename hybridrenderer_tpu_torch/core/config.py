"""Static render configuration (hybridrenderer_tpu/core/config.py).

Only the fields the hybrid path reads are ported, with the reference's
defaults. The reference's kernel-backend fields (raster_backend,
trace_backend, svgf_backend, svgf_temporal_gather, bvh_builder) pick
Pallas or jnp by platform; here the device of the tensors picks the
kernel or its plain version, so they are not fields and passing one
raises TypeError. Nothing is read from the environment.
"""
from __future__ import annotations

import dataclasses

from .types import DisplayMode, RenderFlags, RenderPathType


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
    # Raster kernel attribute output width (f32 only in the port)
    raster_attr_bits: int = 32

    ao_radius: float = 10.0
    # one AO direction per (ao_block x ao_block) pixel block pattern
    ao_interleaved: bool = True
    ao_block: int = 128
    # per-pixel AO draws (ao_interleaved=False) from the blue-noise
    # texture, else from the TEA hash
    use_blue_noise: bool = True

    def __post_init__(self):
        if self.svgf_bits not in (16, 32):
            raise ValueError(f"svgf_bits must be 16 or 32, got "
                             f"{self.svgf_bits}")
        if self.raster_attr_bits != 32:
            raise ValueError("raster_attr_bits=16 is not ported")
        if self.raster_cull not in ("back", "none"):
            raise ValueError(f"raster_cull must be 'back' or 'none', got "
                             f"{self.raster_cull!r}")

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)
