"""Binary BVH over the world-space triangle soup
(hybridrenderer_tpu/ops/bvh.py): the binned-SAH host build of
native/bvh_builder.cpp, loaded through ctypes (native.bvh_library).

Node indexing for T triangles: internal nodes 0 .. T-2 (root 0), leaf k
= node (T-1)+k holding one triangle.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Any

import numpy as np
import torch

from .. import native


@dataclasses.dataclass
class BVH:
    node_min: Any   # (2T-1, 3) f32
    node_max: Any   # (2T-1, 3) f32
    left: Any       # (2T-1,) i32 child node id, -1 for leaves
    right: Any      # (2T-1,) i32
    tri: Any        # (2T-1,) i32 triangle id for leaves, -1 internal
    num_tris: int


def build_sah(v0, v1, v2, device=None) -> BVH:
    """(T, 3) world-space triangle corners → binned-SAH BVH on
    ``device`` (default: the corners' device). The build runs on the
    host; a failed build raises."""
    device = v0.device if device is None else torch.device(device)
    a0, a1, a2 = (np.ascontiguousarray(v.detach().cpu().numpy(), np.float32)
                  for v in (v0, v1, v2))
    T = a0.shape[0]
    if T == 0:
        raise ValueError("cannot build a BVH over zero triangles")
    N = 2 * T - 1
    nmin = np.empty((N, 3), np.float32)
    nmax = np.empty((N, 3), np.float32)
    left = np.empty((N,), np.int32)
    right = np.empty((N,), np.int32)
    tri = np.empty((N,), np.int32)

    def p(x, t):
        return x.ctypes.data_as(ctypes.POINTER(t))

    f, i = ctypes.c_float, ctypes.c_int32
    rc = native.bvh_library().hrtpu_build_sah(
        p(a0, f), p(a1, f), p(a2, f), T, p(nmin, f), p(nmax, f),
        p(left, i), p(right, i), p(tri, i))
    if rc != 0:
        raise RuntimeError(f"hrtpu_build_sah failed with code {rc}")
    return BVH(*(torch.from_numpy(x).to(device)
                 for x in (nmin, nmax, left, right, tri)), num_tris=T)
