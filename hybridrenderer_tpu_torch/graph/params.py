"""Per-frame parameters and carried frame state
(hybridrenderer_tpu/graph/params.py)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass
class FrameParams:
    sun_direction: Any     # (3,) tensor
    sun_color: Any         # (3,) tensor
    sun_intensity: Any     # () tensor
    ambient_strength: Any  # () tensor
    exposure: float
    svgf_phi: tuple        # 4 floats, indexed as in ops/svgf.py
    frame_index: int       # RNG decorrelation

    @staticmethod
    def create(scene, exposure=1.0, frame_index=0,
               svgf_phi=(4.0, 128.0, 0.02, 0.0)) -> "FrameParams":
        import numpy as np

        return FrameParams(
            sun_direction=scene.sun.direction,
            sun_color=scene.sun.color,
            sun_intensity=scene.sun.intensity,
            ambient_strength=scene.sun.ambient,
            exposure=float(np.float32(exposure)),
            # values exactly representable in float32, as the kernels
            # and the reference take them
            svgf_phi=tuple(float(x) for x in np.asarray(svgf_phi,
                                                        np.float32)),
            frame_index=int(frame_index),
        )


@dataclasses.dataclass
class FrameState:
    """History tensors carried from frame to frame, by resource name."""

    history: Dict[str, Any]

    @staticmethod
    def empty() -> "FrameState":
        return FrameState(history={})

    def get(self, name, default=None):
        return self.history.get(name, default)


class RS:
    """Canonical resource names."""

    ALBEDO = "Albedo"
    NORMAL = "Normal"
    MATERIAL_PARAMS = "MaterialParams"
    OBJECT_ID = "ObjectID"
    MOTION = "Motion"
    EMISSIVE = "Emissive"
    DEPTH = "Depth"
    CUR_COLOR = "ShadowAO"       # packed shadow + AO signal
    AO_RAW = "AORaw"             # the RTAOPass demo's output
    REFLECTION_RAW = "ReflectionRaw"
    GI_RAW = "GIRaw"
    FINAL_COLOR = "FinalColor"
    TAA_OUTPUT = "TAAOutput"
    RENDER_OUTPUT = "RENDER_OUTPUT"
    WORLD_POS = "WorldPos"
