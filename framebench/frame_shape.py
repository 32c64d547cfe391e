"""A cell's frame as its configuration states it: the render path, the
size, the flags and the settings the kernel counts (roofline/) read.
Which passes a frame runs follows from the path and the flags, as each
path's design has it:

* HYBRID: one G-buffer raster; an any-hit query a pixel for SHADOW and
  for AO, and a shadow query at each radiance hit; a closest-hit query a
  pixel for REFLECTION and for GI; one SVGF chain for the shadow and AO
  signal and one for each radiance signal, each a temporal fetch, a
  moments filter and ``svgf_atrous_iterations`` a-trous steps; no TAA.
* FORWARD: one G-buffer raster; an any-hit sun shadow query a pixel for
  SHADOW; no AO, radiance rays or SVGF; for TAA one history fetch a
  pixel of the three float32 colour planes."""
from __future__ import annotations

import dataclasses

PATHS = ("HYBRID", "FORWARD")
TAA_PLANES = 3


@dataclasses.dataclass(frozen=True)
class FrameShape:
    width: int
    height: int
    flags: frozenset
    settings: dict
    path: str

    @staticmethod
    def of(render: dict) -> "FrameShape":
        path = render["path"]
        if path not in PATHS:
            raise ValueError(f"the frame's passes are counted for the paths "
                             f"{PATHS}, not {path}")
        return FrameShape(int(render["width"]), int(render["height"]),
                          frozenset(render["flags"]),
                          dict(render.get("settings", {})), path)

    @property
    def pixels(self) -> int:
        return self.width * self.height

    @property
    def hybrid(self) -> bool:
        return self.path == "HYBRID"

    def has(self, *flags) -> bool:
        return all(f in self.flags for f in flags)

    @property
    def radiance_queries(self) -> int:
        if not self.hybrid:
            return 0
        return int(self.has("REFLECTION")) + int(self.has("GI"))

    @property
    def any_hit_queries(self) -> int:
        shadow = self.has("SHADOW")
        if not self.hybrid:
            return int(shadow)
        return int(shadow) + int(self.has("AO")) \
            + (self.radiance_queries if shadow else 0)

    @property
    def svgf_chains(self) -> int:
        if not self.hybrid:
            return 0
        return 1 + self.radiance_queries if self.has("SVGF") else 0

    @property
    def taa_fetches(self) -> int:
        """History fetches a pixel (K5), each of TAA_PLANES float32
        planes."""
        return 0 if self.hybrid else int(self.has("TAA"))

    @property
    def svgf_bytes(self) -> int:
        return int(self.settings.get("svgf_bits", 16)) // 8

    @property
    def atrous_steps(self) -> int:
        return int(self.settings.get("svgf_atrous_iterations", 3))
