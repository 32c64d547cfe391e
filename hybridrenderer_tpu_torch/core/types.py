"""Shared enums and flags (hybridrenderer_tpu/core/types.py)."""
from __future__ import annotations

import enum

INVALID_ID = -1


class MaterialType(enum.IntEnum):
    MATTE = 0
    PBR = 1
    VOLUMETRIC = 2
    GLASS = 3
    SUBSURFACE = 4


class DisplayMode(enum.IntEnum):
    FINAL = 0
    ALBEDO = 1
    NORMAL = 2
    MATERIAL = 3
    MOTION = 4
    DEPTH = 5
    SHADOW = 6
    AO = 7
    REFLECTION = 8
    GI = 9
    EMISSIVE = 10
    SVGF_VARIANCE = 11


class RenderFlags(enum.IntFlag):
    NONE = 0
    LIGHT = 1 << 0
    SHADOW = 1 << 1
    AO = 1 << 2
    REFLECTION = 1 << 3
    GI = 1 << 4
    TAA = 1 << 5
    TAA_HISTORY = 1 << 6
    SVGF = 1 << 7
    SVGF_TEMPORAL = 1 << 8
    SVGF_SPATIAL = 1 << 9
    IBL = 1 << 10
    EMISSIVE = 1 << 11

    @classmethod
    def default_hybrid(cls) -> "RenderFlags":
        return (
            cls.LIGHT | cls.SHADOW | cls.SVGF | cls.SVGF_TEMPORAL
            | cls.SVGF_SPATIAL | cls.IBL | cls.AO | cls.EMISSIVE
        )


class RenderPathType(enum.IntEnum):
    FORWARD = 0
    HYBRID = 1
    RAYTRACED = 2
