"""Camera: reversed-Z projection, orbit controls, TAA jitter
(hybridrenderer_tpu/core/camera.py).

The controller math is host-side numpy, as in the reference package.
``CameraState`` carries numpy arrays; ``CameraState.to(device)`` gives
the same block as float32 tensors for a frame.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from . import maths

_FIELDS = ("view", "proj", "view_inverse", "proj_inverse",
           "view_proj_inverse", "prev_view", "prev_proj", "position",
           "jitter", "prev_jitter")


@dataclasses.dataclass
class CameraState:
    """Per-frame camera block (CameraData)."""

    view: Any
    proj: Any
    view_inverse: Any
    proj_inverse: Any
    view_proj_inverse: Any
    prev_view: Any
    prev_proj: Any
    position: Any      # (3,)
    jitter: Any        # (2,) current NDC jitter
    prev_jitter: Any   # (2,)

    @staticmethod
    def create(view, proj, prev_view=None, prev_proj=None,
               jitter=None, prev_jitter=None) -> "CameraState":
        view = np.asarray(view, np.float32)
        proj = np.asarray(proj, np.float32)
        prev_view = view if prev_view is None else np.asarray(prev_view, np.float32)
        prev_proj = proj if prev_proj is None else np.asarray(prev_proj, np.float32)
        zero2 = np.zeros((2,), np.float32)
        jitter = zero2 if jitter is None else np.asarray(jitter, np.float32)
        prev_jitter = zero2 if prev_jitter is None else np.asarray(prev_jitter, np.float32)
        vi = np.linalg.inv(view)
        return CameraState(
            view=view,
            proj=proj,
            view_inverse=vi.astype(np.float32),
            proj_inverse=np.linalg.inv(proj).astype(np.float32),
            view_proj_inverse=np.linalg.inv(proj @ view).astype(np.float32),
            prev_view=prev_view,
            prev_proj=prev_proj,
            position=vi[:3, 3].astype(np.float32),
            jitter=jitter,
            prev_jitter=prev_jitter,
        )

    def to(self, device) -> "CameraState":
        """The same block as float32 tensors on ``device``."""
        return CameraState(**{
            f: torch.as_tensor(np.asarray(getattr(self, f), np.float32),
                               device=device) for f in _FIELDS})


def _perspective_reversed_z_np(fov_y_deg, aspect, near, far):
    focal = 1.0 / np.tan(np.deg2rad(fov_y_deg) * 0.5)
    n, f = float(near), float(far)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = focal / aspect
    m[1, 1] = -focal
    m[2, 2] = n / (f - n)
    m[2, 3] = n * f / (f - n)
    m[3, 2] = -1.0
    return m


def _quat_from_pitch_yaw_np(pitch, yaw):
    hp, hy = -pitch * 0.5, -yaw * 0.5
    cp, sp = np.cos(hp), np.sin(hp)
    cy, sy = np.cos(hy), np.sin(hy)
    return np.array([cp * cy, sp * cy, cp * sy, -sp * sy], np.float32)


def _quat_rotate_np(q, v):
    w, u = q[0], q[1:4]
    return (2.0 * np.dot(u, v) * u + (w * w - np.dot(u, u)) * v
            + 2.0 * w * np.cross(u, v))


def _quat_to_mat3_np(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


class OrbitCamera:
    """Host-side orbit camera (EditorCamera semantics). ``step()``
    advances the jitter phase and rolls matrices into the
    previous-frame slots."""

    def __init__(self, fov_deg=45.0, width=512, height=512,
                 near=0.1, far=1000.0,
                 focal_point=(0.0, 0.0, 0.0), distance=5.0,
                 pitch=0.0, yaw=0.0):
        self.fov_deg = fov_deg
        self.width, self.height = width, height
        self.near, self.far = near, far
        self.focal_point = np.asarray(focal_point, np.float32)
        self.distance = float(distance)
        self.pitch, self.yaw = float(pitch), float(yaw)
        self.frame_count = 0
        self._jitter_table = maths.halton_jitter_sequence(width, height)
        self._prev_view = None
        self._prev_proj = None
        self._prev_jitter = np.zeros((2,), np.float32)

    @property
    def orientation(self):
        return _quat_from_pitch_yaw_np(self.pitch, self.yaw)

    @property
    def forward(self):
        return _quat_rotate_np(self.orientation, np.array([0, 0, -1.0], np.float32))

    @property
    def right(self):
        return _quat_rotate_np(self.orientation, np.array([1.0, 0, 0], np.float32))

    @property
    def up(self):
        return _quat_rotate_np(self.orientation, np.array([0, 1.0, 0], np.float32))

    @property
    def position(self):
        return self.focal_point - self.forward * self.distance

    def view_matrix(self):
        rot = _quat_to_mat3_np(self.orientation)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = rot
        m[:3, 3] = self.position
        return np.linalg.inv(m).astype(np.float32)

    def proj_matrix(self):
        return _perspective_reversed_z_np(
            self.fov_deg, self.width / self.height, self.near, self.far)

    def orbit(self, d_yaw: float, d_pitch: float):
        self.yaw += d_yaw
        self.pitch += d_pitch

    def step(self, taa_enabled: bool = False) -> CameraState:
        view = self.view_matrix()
        proj = self.proj_matrix()
        if taa_enabled:
            jitter = self._jitter_table[self.frame_count % 16]
        else:
            jitter = np.zeros((2,), np.float32)
        state = CameraState.create(
            view, proj,
            prev_view=self._prev_view if self._prev_view is not None else view,
            prev_proj=self._prev_proj if self._prev_proj is not None else proj,
            jitter=jitter, prev_jitter=self._prev_jitter,
        )
        self._prev_view, self._prev_proj = view, proj
        self._prev_jitter = jitter
        self.frame_count += 1
        return state
