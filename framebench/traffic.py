"""The one traffic generator: what a user does between frames, read
from a traffic file's parameters and drawn from the seed.

A traffic file (``traffic/<name>.json``) holds:

* ``camera``: the orbit camera of the editor (distance, pitch, yaw,
  focal point, fov, near, far), ``yaw_jitter`` (the seed moves the start
  yaw by a uniform draw in [-yaw_jitter, yaw_jitter]), ``orbit`` (rad a
  frame, 0 for a fixed camera) and ``taa_jitter`` (the 16-phase Halton
  sub-pixel jitter, stepped every frame);
* ``motion`` (optional): ``entities`` entities of kind ``kind``, chosen
  by the seed, each turned about the scene's vertical axis by ``rot_y``
  x k before frame k (k from 1), through the dynamic scene's update: the
  transform rot_y(``rot_y`` k) of bench.py's dynamic rung, applied to
  the entity's own, so that the entity travels a circle about the
  origin.

Frame k's camera and transforms depend only on k and the seed, so the
check after the window can hand the same frames to the program and to
the reference. The camera math is the editor camera's
(hybridrenderer_tpu_torch/core/camera.py), copied as numpy.
"""
from __future__ import annotations

import numpy as np


def halton(index: int, base: int) -> float:
    f, r = 1.0, 0.0
    while index > 0:
        f /= base
        r += f * (index % base)
        index //= base
    return r


def halton_jitter(width: int, height: int, phases: int = 16):
    out = np.zeros((phases, 2), np.float32)
    for p in range(phases):
        out[p, 0] = (halton(p + 1, 2) - 0.5) * (2.0 / width)
        out[p, 1] = (halton(p + 1, 3) - 0.5) * (2.0 / height)
    return out


def perspective_reversed_z(fov_y_deg, aspect, near, far):
    focal = 1.0 / np.tan(np.deg2rad(fov_y_deg) * 0.5)
    n, f = float(near), float(far)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = focal / aspect
    m[1, 1] = -focal
    m[2, 2] = n / (f - n)
    m[2, 3] = n * f / (f - n)
    m[3, 2] = -1.0
    return m


def _quat(pitch, yaw):
    hp, hy = -pitch * 0.5, -yaw * 0.5
    cp, sp = np.cos(hp), np.sin(hp)
    cy, sy = np.cos(hy), np.sin(hy)
    return np.array([cp * cy, sp * cy, cp * sy, -sp * sy], np.float32)


def _rotate(q, v):
    w, u = q[0], q[1:4]
    return (2.0 * np.dot(u, v) * u + (w * w - np.dot(u, u)) * v
            + 2.0 * w * np.cross(u, v))


def _mat3(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def view_matrix(focal_point, distance, pitch, yaw):
    q = _quat(pitch, yaw)
    forward = _rotate(q, np.array([0, 0, -1.0], np.float32))
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = _mat3(q)
    m[:3, 3] = np.asarray(focal_point, np.float32) - forward * distance
    return np.linalg.inv(m).astype(np.float32)


def rot_y(a):
    c, s = float(np.cos(a)), float(np.sin(a))
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0],
                     [0, 0, 0, 1]], np.float32)


class Traffic:
    """Frame k's inputs (k from 1) for a scene of ``kinds`` (each
    entity's kind) at ``width`` x ``height``."""

    def __init__(self, params: dict, seed: int, width: int, height: int,
                 kinds, transforms):
        cam = params["camera"]
        rng = np.random.default_rng([seed, 1])
        self.focal_point = np.asarray(cam["focal_point"], np.float32)
        self.distance, self.pitch = float(cam["distance"]), float(cam["pitch"])
        self.yaw0 = float(cam["yaw"]) + float(
            rng.uniform(-1.0, 1.0) * cam.get("yaw_jitter", 0.0))
        self.orbit = float(cam.get("orbit", 0.0))
        self.proj = perspective_reversed_z(
            cam.get("fov", 45.0), width / height, cam.get("near", 0.1),
            cam.get("far", 1000.0))
        self.jitter = halton_jitter(width, height) \
            if cam.get("taa_jitter", True) else np.zeros((16, 2), np.float32)
        self.moved, self.turn = [], 0.0
        motion = params.get("motion")
        if motion:
            pool = [i for i, k in enumerate(kinds) if k == motion["kind"]]
            self.moved = [int(e) for e in rng.choice(
                pool, size=int(motion["entities"]), replace=False)]
            self.turn = float(motion["rot_y"])
        self.base = {e: np.asarray(transforms[e], np.float32)
                     for e in self.moved}

    def camera(self, k: int):
        """Frame k's (view, proj, prev_view, prev_proj, jitter,
        prev_jitter): the camera orbits ``orbit`` rad a frame from the
        start yaw and steps its jitter phase each frame; frame 1's
        previous matrices are its own, with a zero previous jitter."""
        def view(i):
            return view_matrix(self.focal_point, self.distance, self.pitch,
                               self.yaw0 + self.orbit * (i - 1))
        prev = view(k - 1) if k > 1 else view(k)
        prev_jitter = self.jitter[(k - 2) % 16] if k > 1 \
            else np.zeros((2,), np.float32)
        return (view(k), self.proj, prev, self.proj,
                self.jitter[(k - 1) % 16], prev_jitter)

    def transforms(self, k: int) -> dict:
        """Entity → its transform before frame k: its own, turned about
        the scene's vertical axis by ``rot_y`` x k."""
        return {e: rot_y(self.turn * k) @ t for e, t in self.base.items()}
