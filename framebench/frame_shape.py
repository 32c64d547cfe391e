"""A cell's frame as its configuration states it: the size, the flags
and the settings the kernel counts (roofline/) read. Which passes a
frame runs follows from the flags, as the hybrid path's design has it:
one G-buffer raster; an any-hit query a pixel for SHADOW and for AO, and
a shadow query at each radiance hit; a closest-hit query a pixel for
REFLECTION and for GI; one SVGF chain for the shadow and AO signal and
one for each radiance signal, each a temporal fetch, a moments filter
and ``svgf_atrous_iterations`` a-trous steps."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FrameShape:
    width: int
    height: int
    flags: frozenset
    settings: dict

    @staticmethod
    def of(render: dict) -> "FrameShape":
        return FrameShape(int(render["width"]), int(render["height"]),
                          frozenset(render["flags"]),
                          dict(render.get("settings", {})))

    @property
    def pixels(self) -> int:
        return self.width * self.height

    def has(self, *flags) -> bool:
        return all(f in self.flags for f in flags)

    @property
    def radiance_queries(self) -> int:
        return int(self.has("REFLECTION")) + int(self.has("GI"))

    @property
    def any_hit_queries(self) -> int:
        shadow = self.has("SHADOW")
        return int(shadow) + int(self.has("AO")) \
            + (self.radiance_queries if shadow else 0)

    @property
    def svgf_chains(self) -> int:
        return 1 + self.radiance_queries if self.has("SVGF") else 0

    @property
    def svgf_bytes(self) -> int:
        return int(self.settings.get("svgf_bits", 16)) // 8

    @property
    def atrous_steps(self) -> int:
        return int(self.settings.get("svgf_atrous_iterations", 3))
