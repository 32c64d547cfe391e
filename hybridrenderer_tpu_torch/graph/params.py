"""Per-frame parameters and carried frame state
(hybridrenderer_tpu/graph/params.py).

A frame's host inputs cross to the device as one float32 row
(``pack_row``, the reference renderer's ``_pack_row``): the packed
camera block, then exposure, the four SVGF phis and the frame index.
``FrameParams.from_row`` reads them there as device values, so a frame
captured into a CUDA graph sees each frame's own values.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..core.camera import CameraState

# the packed camera block, exposure, svgf_phi (4), frame index
ROW_SIZE = CameraState.PACKED_SIZE + 6


def pack_row(cam_state, exposure, svgf_phi, frame_index) -> np.ndarray:
    """One frame's host inputs as a (ROW_SIZE,) float32 row; the frame
    index is exact below 2^24, as in the reference."""
    return np.concatenate([
        cam_state.pack(), np.asarray([exposure], np.float32),
        np.asarray(svgf_phi, np.float32),
        np.asarray([frame_index], np.float32)])


@dataclasses.dataclass
class FrameParams:
    sun_direction: Any     # (3,) tensor
    sun_color: Any         # (3,) tensor
    sun_intensity: Any     # () tensor
    ambient_strength: Any  # () tensor
    # host numbers (``create``) or device values of the frame's row
    # (``from_row``): exposure (), svgf_phi (4,) indexed as in
    # ops/svgf.py, frame_index () i64 for the RNG's decorrelation
    exposure: Any
    svgf_phi: Any
    frame_index: Any

    @staticmethod
    def create(scene, exposure=1.0, frame_index=0,
               svgf_phi=(4.0, 128.0, 0.02, 0.0)) -> "FrameParams":
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

    @staticmethod
    def from_row(scene, row) -> "FrameParams":
        """The parameters of a ``pack_row`` row, a tensor on the scene's
        device, as views and device values of it."""
        off = CameraState.PACKED_SIZE
        return FrameParams(
            sun_direction=scene.sun.direction,
            sun_color=scene.sun.color,
            sun_intensity=scene.sun.intensity,
            ambient_strength=scene.sun.ambient,
            exposure=row[off],
            svgf_phi=row[off + 1:off + 5],
            frame_index=row[off + 5].to(torch.int64),
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
